"""Time variants of the port's kernels on the card.

    python openmp_parallel_computing_tpu_torch/bench/kernel_variants.py [--only PREFIX]

Each variant in VARIANTS is a copy of ``csrc/`` under
``build/variants/<name>/`` with edits to one source: exact text
replacements, or a constant's value by its name. All copies are built in
parallel nvcc processes, each one is checked bit for bit against its plain
version at the main path's shapes (but the FLOORS, which leave part of
the work out to show what the rest costs), and each is timed by torch.profiler
device time a launch in two rounds: the gather sampler on the rollout's
points (``bench/sweep_kernels.py``'s ``sampler_cases``), ``edge_pyramid``
on the 1080p frame and the 6 MP photo at s=16. Prints one JSON line with
the card's name and power limit and, for each variant, its ptxas
register and spill lines and its times. How the run, strip and ring sizes
of csrc/edge_pyramid.cu and the sampler's form were chosen (PERF.md §6).
Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "variants"
ROUNDS = 2
ITERS = 20


def const(name: str, value) -> tuple:
    """The edit that sets ``constexpr int <name>`` to ``value``."""
    return (f"constexpr int {name} = ", value)


# The sampler's shared-memory form on the source as it is: a resident grid
# (the SMs times the blocks an SM holds at this shared memory) whose every
# block copies the levels into shared memory once, then walks the groups
# grid-stride, reading the texels from shared memory.
SAMPLER_SHARED = [
    ("#include <stdint.h>\n\nnamespace {",
     "#include <stdint.h>\n\nextern __shared__ float4 sample_smem[];\n\n"
     "namespace {"),
    ("  float xhi, yhi;          // wf - 1, hf - 1: the clip\n};",
     "  float xhi, yhi;          // wf - 1, hf - 1: the clip\n"
     "  int at;                  // first float in shared memory\n};"),
    ("  float half_w, half_h, inv255;\n};",
     "  float half_w, half_h, inv255;\n  int smem;\n};"),
    ("    const float* row = lv.L + (size_t)y0 * lv.wf + x0;",
     "    const float* row = reinterpret_cast<const float*>(sample_smem) +\n"
     "                       lv.at + y0 * lv.wf + x0;"),
    ("const float L00 = __ldg(row);", "const float L00 = row[0];"),
    ("__ldg(row + 1)", "row[1]"),
    ("__ldg(row + lv.wf)", "row[lv.wf]"),
    ("__ldg(row + lv.wf + 1)", "row[lv.wf + 1]"),
    ("""  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_groups) return;
  const int mb = P.m * P.B;""", """  float* sm = reinterpret_cast<float*>(sample_smem);
  for (int l = 0; l < P.nlev; ++l) {
    const Level& lv = P.lv[l];
    const int n = lv.hf * lv.wf;
    int t = threadIdx.x;
    if ((reinterpret_cast<uintptr_t>(lv.L) & 15) == 0) {
      for (; t < n / 4; t += blockDim.x)
        reinterpret_cast<float4*>(sm + lv.at)[t] =
            __ldg(reinterpret_cast<const float4*>(lv.L) + t);
      t = n / 4 * 4 + threadIdx.x;
    }
    for (; t < n; t += blockDim.x) sm[lv.at + t] = __ldg(lv.L + t);
  }
  __syncthreads();
  const int mb = P.m * P.B;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P.n_groups;
       i += gridDim.x * blockDim.x) {"""),
    ("""    store_vec<kVec>(gk + mb + r, gy);
  }
}""", """    store_vec<kVec>(gk + mb + r, gy);
  }
  }
}"""),
    ("""  const unsigned blocks = (unsigned)((P.n_groups + kThreads - 1) / kThreads);
  sample_kernel<kGrads, kVec><<<blocks, kThreads, 0, s>>>(x, y, v, g, P);""",
     """  auto kernel = sample_kernel<kGrads, kVec>;
  int dev = 0, sms = 0, fit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       P.smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads,
                                                P.smem);
  const int want = (P.n_groups + kThreads - 1) / kThreads;
  const int blocks = want < sms * fit ? want : sms * fit;
  kernel<<<blocks, kThreads, P.smem, s>>>(x, y, v, g, P);"""),
    ("  Params P{};\n  for (int l = 0; l < nlev; ++l) {",
     "  Params P{};\n  int at = 0;\n  for (int l = 0; l < nlev; ++l) {"),
    ("""                    (float)(wf - 1), (float)(hf - 1)};
  }""", """                    (float)(wf - 1), (float)(hf - 1), at};
    at += (hf * wf + 3) / 4 * 4;
  }
  P.smem = at * (int)sizeof(float);"""),
]

# name -> (source, edits); the first of each source is the source as it is.
VARIANTS = {
    "edge_pyramid": ("edge_pyramid", []),
    "edge_pyramid_strip8": ("edge_pyramid", [const("kPyrStripRows", 8)]),
    "edge_pyramid_strip16": ("edge_pyramid", [const("kPyrStripRows", 16)]),
    "edge_pyramid_ring2": ("edge_pyramid", [const("kPyrRingRows", 2)]),
    "edge_pyramid_run8": ("edge_pyramid", [const("kPyrRun", 8)]),
    "edge_pyramid_run8_strip8": ("edge_pyramid", [const("kPyrRun", 8),
                                                  const("kPyrStripRows", 8)]),
    "edge_pyramid_run16_strip16": ("edge_pyramid", [
        const("kPyrRun", 16), const("kPyrStripRows", 16)]),
    "sampler": ("sampler", []),
    "sampler_one_point": ("sampler", [const("kPoints", 1)]),
    "sampler_two_levels": ("sampler", [(
        "  for (int l = 0; l < P.nlev; ++l)\n    add_level",
        "  if (P.nlev == 2) {\n#pragma unroll\n"
        "    for (int l = 0; l < 2; ++l)\n"
        "      add_level<kGrads, kVec>(P, P.lv[l], xp, yp, acc, gx, gy);\n"
        "  } else for (int l = 0; l < P.nlev; ++l)\n    add_level")]),
    "sampler_shared": ("sampler", SAMPLER_SHARED),
    "sampler_shared_one_point": ("sampler", SAMPLER_SHARED
                                 + [const("kPoints", 1)]),
    "sampler_no_levels": ("sampler", [("for (int l = 0; l < P.nlev; ++l)",
                                       "for (int l = 0; l < 0; ++l)")]),
}
# Floors, timed but not checked: the launch without part of its work.
FLOORS = {"sampler_no_levels"}


def edited(text: str, edits) -> str:
    """``text`` with each edit applied; each must match exactly once."""
    for old, new in edits:
        if old.startswith("constexpr int "):
            i = text.index(old) + len(old)
            text = text[:i] + str(new) + text[text.index(";", i):]
        elif text.count(old) != 1:
            raise ValueError(f"edit matches {text.count(old)} times: "
                             f"{old[:60]!r}")
        else:
            text = text.replace(old, new)
    return text


def prepare(names, csrc: Path, out: Path = OUT) -> dict:
    """``{name: directory}``: a copy of ``csrc`` for each variant under
    ``out``, with its source edited."""
    dirs = {}
    for name in names:
        source, edits = VARIANTS[name]
        d = out / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d / "csrc")
        path = d / "csrc" / f"{source}.cu"
        path.write_text(edited(path.read_text(), edits))
        dirs[name] = d
    return dirs


def use(build, d: Path) -> None:
    """Point the build module at variant directory ``d``."""
    build.CSRC, build.BUILD_DIR = d / "csrc", d / "build"
    build._libs.clear()


def ptxas_lines(report: str) -> list:
    return [line.strip() for line in report.splitlines()
            if "registers" in line or "spill stores" in line]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="time only the variants whose name starts with this")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import torch

    from openmp_parallel_computing_tpu_torch import _build, data
    from openmp_parallel_computing_tpu_torch.bench import (
        image_kernels, sweep_kernels)
    from openmp_parallel_computing_tpu_torch.models.mpc import sampler
    from openmp_parallel_computing_tpu_torch.ops import pipeline

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel variants run on a GPU")
    names = [n for n in VARIANTS if n.startswith(args.only)]
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    dirs = prepare(names, csrc)
    jobs = {}
    for name in names:             # every nvcc at once, then wait for each
        use(_build, dirs[name])
        jobs[name] = _build._start(VARIANTS[name][0])
    report = {}
    for name in names:
        use(_build, dirs[name])
        if jobs[name] is not None:
            _build._finish(VARIANTS[name][0], jobs[name])
        report[name] = {"ptxas": ptxas_lines(
            _build._target(VARIANTS[name][0])[1].read_text())}

    frame = data.load_frame_planar("cuda")
    photo = chip_smoke.load_planar(data.six_mp_path(), "cuda")
    timed = {"sampler": sweep_kernels.sampler_cases(chip_smoke, frame),
             "edge_pyramid": {
                 k: v for k, v in image_kernels.cases(
                     chip_smoke, {"1080p": frame, "6mp": photo},
                     passes=1).items() if k.startswith("edge_pyramid")}}
    plain = {"sampler": [sampler.sample_plain(*call.args, **call.keywords)
                         for key, (call, _, _) in timed["sampler"].items()
                         if "_vg_" in key],
             "edge_pyramid": [pipeline.edge_pyramid_base_plain(img)
                              for img in (frame, photo)]}
    for rnd in range(ROUNDS):
        for name in names:
            use(_build, dirs[name])
            source = VARIANTS[name][0]
            if rnd == 0 and name not in FLOORS:   # bit for bit
                if source == "sampler":
                    got = [call() for key, (call, _, _)
                           in timed[source].items() if "_vg_" in key]
                    pairs = [(a, b) for g_, p_ in zip(got, plain[source])
                             for a, b in zip(g_, p_)]
                else:
                    pairs = list(zip([pipeline.edge_pyramid_base(img)
                                      for img in (frame, photo)],
                                     plain[source]))
                if not all(torch.equal(a, b) for a, b in pairs):
                    raise AssertionError(f"variant {name} != plain version")
            for key, (call, kernel, _) in timed[source].items():
                us = chip_smoke.device_us(call, kernel, ITERS)
                report[name].setdefault(key, []).append(us)
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    _build._libs.clear()
    print(json.dumps({"device": chip_smoke.nvidia_smi_line(),
                      "variants": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
