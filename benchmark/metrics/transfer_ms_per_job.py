"""Host time of a job's transfers and layout changes, in ms a job: the
host intervals of the program's ``image.upload`` (HWC -> CHW on the host
and the copy to the card) and ``image.fetch`` (the result to the host and
CHW -> HWC) spans over its ``image.job`` spans. Layer: transfers and host
layout. Moves ``step_ms_p95``.

The fetch waits for the card to finish the job's passes before its
copy, so it holds whatever device work the passes' issue left queued.
Spans are recorded only while the profiler records, so the log holds the
traced slice alone. A program without the spans gives None."""

PARTS = ("image.upload", "image.fetch")
JOB = "image.job"


def program_spans():
    """The program's span log (``utils.metrics.registry.spans()``), or
    None where the program records none."""
    try:
        from openmp_parallel_computing_tpu_torch.utils.metrics import (
            registry)

        return registry.spans()
    except (ImportError, AttributeError):
        return None


def read(summary: dict):
    spans = program_spans()
    if not spans:
        return None
    jobs = sum(1 for s in spans if s["name"] == JOB)
    ms = [s["host_ms"] for s in spans if s["name"] in PARTS]
    if not jobs or not ms:
        return None
    return sum(ms) / jobs
