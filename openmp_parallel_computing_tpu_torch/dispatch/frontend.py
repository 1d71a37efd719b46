"""Frontend / job orchestrator for the async tier (port of
``openmp_parallel_computing_tpu.dispatch.frontend``: the same routes, page
and messages; it touches no device).

Capability twin of ``event-driven/frontend/app.py:1-323``: upload + job
submission on ``POST /``, ``GET /status?key=`` polling, ``GET /image/<key>``
store proxy, and a dashboard that charts per-device-count times and derived
speed-ups (t(1)/t(N), computed client-side exactly like the reference's
Chart.js page, ``frontend/app.py:246-250``) — rendered with dependency-free
inline SVG instead of a vendored chart library.

Completion results are read from the ``<queue>_processed`` durable queue
into a dict AND stay re-derivable from the store (``status/<name>.json``),
so results survive a frontend restart (the reference's in-memory
``PROCESSED`` dict, ``frontend/app.py:38``, does not).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path, PurePosixPath

from openmp_parallel_computing_tpu_torch.dispatch.broker import (
    BrokerError,
    make_queue,
    make_store,
)
from openmp_parallel_computing_tpu_torch.dispatch.validate import (
    CONFIG_FIELDS,
    MAX_REPEAT,
    validate_mpc_config,
)
from openmp_parallel_computing_tpu_torch.serve.server import _parse_multipart
from openmp_parallel_computing_tpu_torch.utils.config import DispatchConfig
from openmp_parallel_computing_tpu_torch.utils.httpguard import (
    BodyTooLarge,
    read_body,
)

_PAGE = """<!doctype html>
<html><head><title>ompc dispatch</title>
<style>
 body {{ font-family: sans-serif; margin: 2rem; max-width: 720px; }}
 fieldset {{ margin-bottom: 1rem; }}
 .bar {{ fill: #4a7ebb; }} .bar2 {{ fill: #53a567; }}
 text {{ font-size: 11px; }}
</style></head><body>
<h2>Batch edge/grayscale processing</h2>
<form method="post" enctype="multipart/form-data">
 <fieldset><legend>Job</legend>
  <input type="file" name="image" required>
  <label>kernel <select name="kernel">{kernel_options}</select></label>
  <label>devices <input name="threads" value="{threads}" size="8"></label>
  <label>repeat <input name="repeat" value="{repeat}" size="4"></label>
  <label>passes <input name="passes" value="{passes}" size="4"></label>
  <button>Submit</button>
 </fieldset>
</form>
<div id="result"></div>
<script>
const key = {key_json};
// HTML-escape before any innerHTML interpolation: the error string can
// carry attacker-influenced text (exception reprs of a malformed
// upload), and keys ride URLs.
const esc = t => String(t).replace(/[&<>"']/g,
  c => ({{'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}}[c]));
async function poll() {{
  if (!key) return;
  const r = await fetch('/status?key=' + encodeURIComponent(key));
  const s = await r.json();
  if (!s.processed) {{ setTimeout(poll, 2000); return; }}
  if (s.error) {{
    document.getElementById('result').innerHTML =
      `<p>job failed: <code>${{esc(s.error)}}</code></p>`;
    return;
  }}
  if (s.u0_key) {{  // MPC completion: cost summary + result download
    const t = Object.entries(s.times).map(
      ([d, v]) => `${{d}} device(s): ${{v.toFixed(3)}}s`).join(', ');
    document.getElementById('result').innerHTML =
      `<h4>MPC batch solved</h4>` +
      `<p>${{s.scenarios}} scenarios — mean final cost ` +
      `${{s.costs.mean.toFixed(4)}}, max primal residual ` +
      `${{s.costs.max_primal_residual.toFixed(4)}}</p>` +
      `<p>solve time: ${{t}}</p>` +
      `<p><a href="/image/${{encodeURIComponent(s.u0_key)}}">result npz</a> ` +
      `(u0 / costs / primal_residual)</p>`;
    return;
  }}
  const times = s.times, devs = Object.keys(times);
  const base = times[devs[0]];
  let bars = '', bars2 = '', W = 60;
  devs.forEach((d, i) => {{
    const t = times[d], su = base / t;
    const h1 = 120 * t / Math.max(...devs.map(k => times[k]));
    const h2 = 120 * su / Math.max(...devs.map(k => base / times[k]));
    bars  += `<rect class=bar x=${{i * W}} y=${{130 - h1}} width=40 height=${{h1}}/>` +
             `<text x=${{i * W}} y=145>${{d}}dev ${{t.toFixed(3)}}s</text>`;
    bars2 += `<rect class=bar2 x=${{i * W}} y=${{130 - h2}} width=40 height=${{h2}}/>` +
             `<text x=${{i * W}} y=145>${{d}}dev ${{su.toFixed(2)}}x</text>`;
  }});
  document.getElementById('result').innerHTML =
    `<p>done: <a href="/image/${{encodeURIComponent(s.processed_key)}}">result image</a></p>` +
    `<h4>time per device count</h4><svg width=400 height=150>${{bars}}</svg>` +
    `<h4>speed-up (t1/tN)</h4><svg width=400 height=150>${{bars2}}</svg>`;
}}
poll();
</script></body></html>
"""


def _kernel_options() -> str:
    """The kernel <select> options, generated from the plug-in registry so
    a register_kernel() call surfaces in the UI without editing this file
    (the reference requires a frontend action per new algorithm,
    event-driven/README.md:97-105)."""
    from openmp_parallel_computing_tpu_torch.ops.runner import kernel_names

    return "".join(f"<option>{n}</option>" for n in kernel_names())


def _js_str(value) -> str:
    """JSON-encode a value for embedding inside an HTML <script> block.

    json.dumps alone is NOT script-safe: a string containing
    '</script>' terminates the script element mid-string (reflected XSS
    through the GET /?key=... re-attach path). Escaping '<' keeps the
    payload inert while remaining valid JS."""
    return json.dumps(value).replace("<", "\\u003c")


class FrontendState:
    def __init__(self, cfg: DispatchConfig):
        self.cfg = cfg
        # Directory root -> filesystem backend; http:// root -> the
        # network broker (multi-machine dispatch; see dispatch/broker.py).
        self.store = make_store(cfg.root, token=cfg.auth_token)
        self.jobs = make_queue(cfg.root, cfg.queue, token=cfg.auth_token)
        self.done = make_queue(cfg.root, f"{cfg.queue}_processed",
                               token=cfg.auth_token)
        self.processed: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._consumer = threading.Thread(target=self._consume, daemon=True)
        self._consumer.start()

    def _consume(self) -> None:
        # Background consumer thread (frontend/app.py:37-59). Transport
        # errors from a network-backed queue (broker restart/outage) are
        # retried, not fatal: a dead daemon thread would strand every
        # later completion unacked with no visible symptom.
        while not self._stop.is_set():
            try:
                job = self.done.claim()
                if job is None:
                    self._stop.wait(0.3)
                    continue
                with self._lock:
                    self.processed[job.body["image_key"]] = job.body
                self.done.ack(job)
            except (ConnectionError, BrokerError):
                self._stop.wait(5.0)  # broker back soon; claims redeliver

    def submit(self, filename: str, data: bytes, threads: list[int],
               repeat: int, passes: int, kernel: str) -> str:
        key = f"uploads/{uuid.uuid4()}_{filename}"
        self.store.put(key, data)
        self.jobs.publish({
            "image_key": key,
            "threads": threads,
            "repeat": repeat,
            "passes": passes,
            "kernel": kernel,
        })
        return key

    def submit_mpc(self, scen_npz: bytes, config: dict, devices: int = 1,
                   frame: bytes | None = None, frame_name: str = "frame.png",
                   chunk: int | None = None, repeat: int = 1) -> str:
        """Publish an MPC scenario-batch job (the flagship compute routed
        through the async tier, like the reference routes its kernel
        through the queue worker). Returns the scenario key to poll."""
        uid = uuid.uuid4()
        key = f"uploads/{uid}_scen.npz"
        self.store.put(key, scen_npz)
        body = {"type": "mpc", "scenario_key": key, "config": config,
                "devices": devices, "repeat": repeat}
        if frame is not None:
            frame_key = f"uploads/{uid}_{frame_name}"
            self.store.put(frame_key, frame)
            body["frame_key"] = frame_key
        if chunk is not None:
            body["chunk"] = chunk
        self.jobs.publish(body)
        return key

    def status(self, key: str) -> dict:
        with self._lock:
            body = self.processed.get(key)
        if body is not None:
            return {"processed": True, **body}
        # Restart durability: the in-memory dict dies with the process, but
        # the worker also persists the completion record (with timings) to
        # the object store — read it back if present.
        status_key = f"status/{Path(key).name}.json"
        if key.startswith("uploads/") and self.store.exists(status_key):
            body = json.loads(self.store.get(status_key))
            with self._lock:
                self.processed[key] = body
            return {"processed": True, **body}
        return {"processed": False}

    def shutdown(self) -> None:
        self._stop.set()
        self._consumer.join(timeout=2)


def make_handler(state: FrontendState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                # /?key=<job key> re-attaches the dashboard to any job —
                # notably MPC submissions, whose POST /mpc returns JSON
                # (the key) rather than this page.
                q = urllib.parse.parse_qs(url.query)
                key = q.get("key", [None])[0]
                page = _PAGE.format(threads="1", repeat="1", passes="1",
                                    key_json=_js_str(key),
                                    kernel_options=_kernel_options())
                self._send(200, page.encode(), "text/html")
            elif url.path == "/status":
                q = urllib.parse.parse_qs(url.query)
                key = q.get("key", [""])[0]
                self._send(200, json.dumps(state.status(key)).encode(),
                           "application/json")
            elif url.path.startswith("/image/"):
                key = urllib.parse.unquote(url.path[len("/image/"):])
                if not state.store.exists(key):
                    self.send_error(404)
                    return
                # MPC result payloads (npz) proxy through the same route;
                # serve them as a download, not a PNG.
                ctype = ("application/octet-stream" if key.endswith(".npz")
                         else "image/png")
                self._send(200, state.store.get(key), ctype)
            else:
                self.send_error(404)

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            try:
                body = read_body(self,
                                 state.cfg.max_body_mb * 1024 * 1024)
            except BodyTooLarge as exc:
                # 413 before ingesting: send_error marks Connection:
                # close, unsticking the half-sent upload.
                self.send_error(413, str(exc))
                return
            except ValueError as exc:
                self.send_error(400, str(exc))
                return
            filenames: dict[str, str] = {}
            fields = _parse_multipart(self.headers.get("Content-Type", ""),
                                      body, filenames)
            if url.path == "/mpc":
                self._post_mpc(fields, filenames)
                return
            image = fields.get("image")
            if not isinstance(image, bytes) or not image:
                self.send_error(400, "missing image")
                return
            threads = [int(t) for t in
                       str(fields.get("threads", "1")).split(",")]
            # Preserve the client's filename in the object key, exactly
            # like the reference's uploads/{uuid}_{filename}
            # (event-driven/frontend/app.py:289) — concurrent jobs stay
            # distinguishable in the store listing. Sanitize path parts.
            upload_name = PurePosixPath(
                str(filenames.get("image", "upload.bin"))
                .replace("\\", "/")).name or "upload.bin"
            key = state.submit(
                filename=upload_name, data=image, threads=threads,
                repeat=int(fields.get("repeat", 1)),
                passes=int(fields.get("passes", 1)),
                kernel=str(fields.get("kernel", "grayscale")))
            page = _PAGE.format(
                threads=",".join(map(str, threads)),
                repeat=fields.get("repeat", "1"),
                passes=fields.get("passes", "1"),
                key_json=_js_str(key),
                kernel_options=_kernel_options())
            self._send(200, page.encode(), "text/html")

        def _post_mpc(self, fields, filenames):
            """POST /mpc: multipart 'scenarios' (npz with p0/target/depth
            [/us0]) + optional 'frame' image + form fields (horizon,
            num_features, devices, chunk, repeat). Returns JSON with the
            scenario key to poll on /status."""
            scen = fields.get("scenarios")
            if not isinstance(scen, bytes) or not scen:
                self.send_error(400, "missing multipart field 'scenarios'")
                return
            frame = fields.get("frame")
            try:
                # Validate config overrides BEFORE publishing: bad values
                # are a 400 here, not a poisoned message the worker has to
                # dead-letter (and the bounds stop unauthenticated compile
                # churn, the dispatch twin of serve's ALLOWED_HORIZONS).
                config = validate_mpc_config(
                    {name: fields[name] for name in CONFIG_FIELDS
                     if name in fields})
                repeat = int(str(fields.get("repeat", 1)))
                if not 1 <= repeat <= MAX_REPEAT:
                    raise ValueError(f"repeat must be in 1..{MAX_REPEAT}")
                key = state.submit_mpc(
                    scen, config,
                    devices=int(str(fields.get("devices", 1))),
                    frame=frame if isinstance(frame, bytes) and frame
                    else None,
                    chunk=int(str(fields["chunk"]))
                    if "chunk" in fields else None,
                    repeat=repeat)
            except (ValueError, KeyError) as exc:
                self.send_error(400, str(exc))
                return
            self._send(200, json.dumps({
                "key": key,
                "dashboard": "/?key=" + urllib.parse.quote(key),
            }).encode(), "application/json")

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve(cfg: DispatchConfig | None = None, port: int = 8080
          ) -> tuple[ThreadingHTTPServer, FrontendState]:
    cfg = cfg or DispatchConfig()
    state = FrontendState(cfg)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    return httpd, state


def main() -> None:
    from openmp_parallel_computing_tpu_torch.utils.config import load

    httpd, _ = serve(load().dispatch)
    print("frontend on :8080")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
