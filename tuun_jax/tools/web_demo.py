"""Local web runtime: the `<tuun-synth>` component served from the JAX engine.

The reference embeds its engine in the browser as a WASM build wrapped by
a custom element + AudioWorklet (web/tuun-synth.js, web/tuun-processor.js,
web/index.html).  The JAX engine cannot run inside a browser, so this
module inverts the topology while keeping the exact same component API:
a localhost HTTP server owns one `TuunSession` per element instance
(`session.py` == the wasm.rs surface), and the served `tuun-synth.js`
custom element pumps rendered float32 blocks from a chunked HTTP stream
into a WebAudio AudioWorklet — the same install -> process -> output
quantum loop as web/tuun-processor.js:46-69, with `process()` running on
the server's end of the wire.

Endpoints:
  GET  /                     demo page (the reference's web/index.html
                             examples, same element attributes)
  GET  /tuun-synth.js        the custom element
  POST /api/install          {id, expression, sliders?, opens?} ->
                             {kind, sliders: [{label, normalized, value}]}
  GET  /api/stream?id=...    chunked raw float32 mono blocks
  POST /api/slider           {id, label, normalized} -> {value}
  POST /api/note_on          {id, key, velocity}   (keys instruments)
  POST /api/note_off         {id, key}
  POST /api/stop             {id}

Run: ``python -m tuun_jax.tools.web_demo [--port 8787] [--platform cpu]``.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

WEB_ROOT = Path(__file__).resolve().parent.parent.parent / "web"


class _Instance:
    """One element's session + streaming state."""

    def __init__(self, session):
        self.session = session
        self.lock = threading.Lock()
        self.generation = 0  # bumped on install/stop to end old streams
        self.kind = None     # "waveform" | "keys" after install


# Sessions kept per element id; the least recently installed is evicted
# past this (its streams end via the generation bump).
MAX_INSTANCES = 32


class TuunWebServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr=("127.0.0.1", 8787), sample_rate: int = 44100,
                 block_size: int = 1024, precision: str = "fast",
                 jit: bool = True):
        super().__init__(addr, _Handler)
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.precision = precision
        self.jit = jit
        self.instances: Dict[str, _Instance] = {}
        self.instances_lock = threading.Lock()

    def instance(self, iid: str) -> Optional[_Instance]:
        """An existing instance, or None — only /api/install creates
        sessions (any other endpoint instantiating a full evaluator +
        tracker for a probe/typo id would leak them unboundedly)."""
        with self.instances_lock:
            return self.instances.get(iid)

    def create_instance(self, iid: str) -> _Instance:
        from ..session import TuunSession

        with self.instances_lock:
            inst = self.instances.pop(iid, None)
            if inst is None:
                inst = _Instance(TuunSession(
                    sample_rate=self.sample_rate,
                    block_size=self.block_size,
                    precision=self.precision, jit=self.jit))
            self.instances[iid] = inst  # (re-)append: LRU order
            while len(self.instances) > MAX_INSTANCES:
                oldest_id, oldest = next(iter(self.instances.items()))
                del self.instances[oldest_id]
                with oldest.lock:
                    oldest.generation += 1  # end its streams
                    oldest.session.stop()
            return inst


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: TuunWebServer

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -- helpers -----------------------------------------------------------

    def _json(self, obj, status=200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _file(self, path: Path, ctype: str) -> None:
        try:
            body = path.read_bytes()
        except OSError:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    # -- routes ------------------------------------------------------------

    def do_GET(self):
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            return self._file(WEB_ROOT / "index.html",
                              "text/html; charset=utf-8")
        if url.path == "/tuun-synth.js":
            return self._file(WEB_ROOT / "tuun-synth.js",
                              "application/javascript")
        if url.path == "/api/stream":
            return self._stream(parse_qs(url.query))
        self.send_error(404)

    def do_POST(self):
        url = urlparse(self.path)
        try:
            body = self._body()
        except (ValueError, json.JSONDecodeError):
            return self._json({"error": "bad json"}, 400)
        try:
            if url.path == "/api/install":
                return self._install(body)
            if url.path == "/api/slider":
                return self._slider(body)
            if url.path == "/api/note_on":
                return self._note(body, on=True)
            if url.path == "/api/note_off":
                return self._note(body, on=False)
            if url.path == "/api/stop":
                return self._stop(body)
        except Exception as exc:  # surfaced to the page's status line
            return self._json({"error": str(exc)}, 400)
        self.send_error(404)

    def _install(self, body: dict):
        inst = self.server.create_instance(str(body["id"]))
        with inst.lock:
            inst.generation += 1
            inst.kind = inst.session.install(
                body["expression"],
                sliders=body.get("sliders") or None,
                opens=tuple(body.get("opens") or ("std",)))
            s = inst.session.sliders
            from ..sliders import denormalize_or_zero
            sliders = [{"label": c.label, "normalized": n,
                        "value": denormalize_or_zero(c.function, n)}
                       for c, n in zip(s.configs, s.normalized_values)]
        return self._json({"kind": inst.kind, "sliders": sliders,
                           "sample_rate": self.server.sample_rate})

    def _known(self, body: dict) -> Optional[_Instance]:
        inst = self.server.instance(str(body.get("id")))
        if inst is None:
            self._json({"error": "unknown id (install first)"}, 404)
        return inst

    def _slider(self, body: dict):
        inst = self._known(body)
        if inst is None:
            return None
        with inst.lock:
            inst.session.update_slider_normalized(
                body["label"], float(body["normalized"]))
            return self._json(
                {"value": inst.session._last_slider_values[body["label"]]})

    def _note(self, body: dict, on: bool):
        inst = self._known(body)
        if inst is None:
            return None
        with inst.lock:
            if on:
                inst.session.note_on(int(body["key"]),
                                     float(body.get("velocity", 100)))
            else:
                inst.session.note_off(int(body["key"]))
        return self._json({"ok": True})

    def _stop(self, body: dict):
        inst = self._known(body)
        if inst is None:
            return None
        with inst.lock:
            inst.generation += 1
            inst.session.stop()
        return self._json({"ok": True})

    def _stream(self, query: dict):
        iid = (query.get("id") or [""])[0]
        inst = self.server.instance(iid)
        if inst is None:
            self.send_error(404)
            return
        generation = inst.generation
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Cache-Control", "no-store")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        import numpy as np

        silence = np.zeros(self.server.block_size, "<f4").tobytes()
        try:
            while True:
                with inst.lock:
                    if inst.generation != generation:
                        break  # superseded by a new install/stop
                    block = inst.session.process()
                    keys = inst.kind == "keys"
                if block is None:
                    if not keys:
                        break
                    # A keys instrument idles between notes: the stream
                    # carries silence so it survives note gaps (otherwise
                    # every release would tear the element down and race
                    # the next note_on's lazy restart).  Silence is paced
                    # at realtime HERE — unpaced, the socket buffer fills
                    # with queued silence and the next note_on sits
                    # behind seconds of it.
                    chunk(silence)
                    import time
                    time.sleep(self.server.block_size
                               / self.server.sample_rate)
                    continue
                # float32 little-endian mono; one tracker block per chunk.
                chunk(block.astype("<f4").tobytes())
            chunk(b"")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away — normal for a stop/navigation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--sample_rate", type=int, default=44100)
    ap.add_argument("--block_size", type=int, default=1024)
    ap.add_argument("--platform", choices=("cpu", "gpu", "default"),
                    default="default",
                    help="force the JAX platform before engine import")
    ap.add_argument("--no-jit", action="store_true")
    ap.add_argument("--precision", default="fast",
                    choices=("fast", "exact"))
    args = ap.parse_args(argv)
    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms", args.platform)
    server = TuunWebServer((args.host, args.port),
                           sample_rate=args.sample_rate,
                           block_size=args.block_size,
                           precision=args.precision, jit=not args.no_jit)
    print(f"tuun web demo: http://{args.host}:{args.port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
