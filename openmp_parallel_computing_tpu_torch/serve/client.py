"""Serving client (port of ``openmp_parallel_computing_tpu.serve.client``).

The reference's ``microservices/grayscale/test_client.py:1-55``: a
multipart POST of an image with ``--threads`` and ``--passes``, the
response PNG saved, the end-to-end request time and the server-side
``X-Elapsed`` and ``X-Compute`` spans printed (the two latencies the
service bench CSV records).

The standard library only (``urllib.request`` and a multipart body built
here): the card's machine has no ``requests``. ``post`` is the request
the benches and tests share.
"""

from __future__ import annotations

import argparse
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path


def multipart(fields: dict | None = None,
              files: dict | None = None) -> tuple[bytes, str]:
    """A multipart/form-data body and its Content-Type: ``fields`` maps
    names to text values, ``files`` names to ``(filename, bytes)``."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in (fields or {}).items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
            f'\r\n\r\n{value}\r\n'.encode())
    for name, (filename, data) in (files or {}).items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
            f'; filename="{filename}"\r\nContent-Type: '
            f'application/octet-stream\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def post(url: str, fields: dict | None = None, files: dict | None = None,
         timeout_s: float = 600.0):
    """POST a multipart form; returns ``(status, headers, body bytes)`` for
    every HTTP status (an error status is an answer, not an exception).
    A failed connection raises ``urllib.error.URLError`` or ``OSError``."""
    body, ctype = multipart(fields, files)
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.headers, exc.read()


def run_request(url: str, image: str | Path, out: str | Path,
                kernel: str = "grayscale", threads: int = 1,
                passes: int = 1, timeout_s: float = 900.0) -> dict:
    """POST ``image`` to ``/<kernel>``, save the PNG answer to ``out``;
    returns the request's wall seconds, the server's ``X-Elapsed`` and
    ``X-Compute`` and the answer's size. An error status raises
    ``urllib.error.HTTPError``. ``timeout_s`` bounds a wedged server."""
    data = Path(image).read_bytes()
    t0 = time.perf_counter()
    status, headers, content = post(
        f"{url.rstrip('/')}/{kernel}",
        fields={"threads": str(threads), "passes": str(passes)},
        files={"image": (Path(image).name, data)}, timeout_s=timeout_s)
    request_s = time.perf_counter() - t0
    if status >= 400:
        raise urllib.error.HTTPError(f"{url.rstrip('/')}/{kernel}", status,
                                     content.decode(errors="replace"),
                                     headers, None)
    Path(out).write_bytes(content)
    return {
        "request_s": request_s,
        "service_s": float(headers.get("X-Elapsed", "nan")),
        "compute_s": float(headers.get("X-Compute", "nan")),
        "bytes": len(content),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("image")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--url", default="http://localhost:5000")
    ap.add_argument("--kernel", default="grayscale")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args(argv)
    r = run_request(args.url, args.image, args.out, args.kernel,
                    args.threads, args.passes)
    print(f"request: {r['request_s']:.4f}s  service: {r['service_s']:.4f}s  "
          f"compute: {r['compute_s']:.4f}s  -> {args.out}")


if __name__ == "__main__":
    main()
