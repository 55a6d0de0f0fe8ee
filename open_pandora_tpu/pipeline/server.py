"""Minimal web UI — the reference's gradio app without the gradio
dependency.

Behavioral spec: /root/reference/gradio_app.py — Blocks app on port 10041
with an image upload, 5 per-round action boxes + buttons, a multi-action
box, and sliders for DDIM steps / guidance / eta / fs / seed
(gradio_app.py:35-84,200-212). gradio is not installable in this image, so
this server reproduces the surface with the stdlib http.server: one page,
the same controls, posts run ChatWM rounds and stream back the mp4.
`--debug` serves the full pipeline on a tiny random-weight config
(gradio_app.py:120-126 no-model stub — ours still runs the real code
path).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

PAGE = """<!doctype html>
<html><head><title>Open-Pandora</title><style>
body{font-family:sans-serif;max-width:720px;margin:2em auto}
label{display:block;margin-top:.6em}input,textarea{width:100%%}
button{margin-top:1em;padding:.5em 2em}</style></head><body>
<h2>Open-Pandora &mdash; interactive world model</h2>
<form method="post" action="/generate" enctype="multipart/form-data">
<label>Conditioning image <input type="file" name="image" required></label>
<label>Actions (one per round, up to 5 lines)
<textarea name="actions" rows="5" placeholder="the car moves forward"></textarea></label>
<label>DDIM steps <input type="number" name="ddim_steps" value="50"></label>
<label>Guidance scale <input type="number" step="0.1" name="ugs" value="4.0"></label>
<label>ETA <input type="number" step="0.1" name="eta" value="1.0"></label>
<label>FS <input type="number" name="fs" value="15"></label>
<label>Seed <input type="number" name="seed" value="123"></label>
<button type="submit">Generate</button></form>
<p>POST /generate returns the mp4; GET /health returns JSON.</p>
</body></html>"""


def _parse_multipart(handler: BaseHTTPRequestHandler):
    """Tiny multipart/form-data parser (stdlib cgi is removed in 3.13)."""
    import re

    ctype = handler.headers.get("Content-Type", "")
    m = re.search(r"boundary=([^;]+)", ctype)
    if not m:
        raise ValueError("not multipart")
    boundary = m.group(1).strip('"').encode()
    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    fields = {}
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        # strip exactly the CRLF that precedes the next boundary marker —
        # rstrip over a char set would eat legitimate trailing 0x2D/0x0D/0x0A
        # bytes of a binary upload
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        dm = re.search(rb'name="([^"]+)"', head)
        if dm:
            fields[dm.group(1).decode()] = payload
    return fields


class PandoraHandler(BaseHTTPRequestHandler):
    """generate_fn(image_bytes, actions, **kw) -> mp4 bytes is injected by
    make_server (keeps the HTTP layer model-free and unit-testable)."""

    generate_fn: Optional[Callable] = None

    def do_GET(self):
        if self.path == "/health":
            self._send(200, b'{"status": "ok"}', "application/json")
        elif self.path in ("/", "/index.html"):
            self._send(200, PAGE.encode(), "text/html")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/generate":
            return self._send(404, b"not found", "text/plain")
        try:
            fields = _parse_multipart(self)
            image = fields["image"]
            actions = [a.strip() for a in
                       fields.get("actions", b"").decode().splitlines()
                       if a.strip()][:5] or ["move"]
            kw = {}
            for k, cast in (("ddim_steps", int), ("ugs", float),
                            ("eta", float), ("fs", int), ("seed", int)):
                if fields.get(k):
                    kw[k] = cast(fields[k].decode())
            mp4 = type(self).generate_fn(image, actions, **kw)
            self._send(200, mp4, "video/mp4")
        except Exception as e:  # noqa: BLE001
            self._send(500, json.dumps({"error": str(e)}).encode(),
                       "application/json")

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet
        pass


def make_server(generate_fn: Callable, port: int = 10041,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    handler = type("BoundHandler", (PandoraHandler,),
                   {"generate_fn": staticmethod(generate_fn)})
    return ThreadingHTTPServer((host, port), handler)


def chatwm_generate_fn(chat, fps: int = 8) -> Callable:
    """Adapt a pipeline ChatWM into the server's generate_fn."""
    import os
    import tempfile

    from PIL import Image

    lock = threading.Lock()

    def generate(image_bytes: bytes, actions, *, ddim_steps: int = 50,
                 ugs: float = 4.0, eta: float = 1.0, fs: int = 15,
                 seed: int = 123) -> bytes:
        with lock:  # one device, one session at a time
            img = Image.open(io.BytesIO(image_bytes))
            frames = chat.generate_video_multiround(
                img, list(actions), ddim_steps=ddim_steps,
                guidance_scale=ugs, eta=eta, fs=fs, seed=seed)
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "out.mp4")
                chat.save_video(path, frames, fps=fps)
                with open(path, "rb") as f:
                    return f.read()

    return generate


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("open-pandora-tpu-server")
    p.add_argument("--port", type=int, default=10041)  # gradio_app.py:214
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--quantize-llm", nargs="?", const="int8",
                   choices=["int8", "nf4"], default=False)
    p.add_argument("--debug", action="store_true",
                   help="tiny random-weight config (smoke mode)")
    args = p.parse_args(argv)

    from open_pandora_tpu.pipeline import cli as cli_mod
    cli_args = ["--image", "/dev/null", "--action", "x"]  # reuse builder
    base = cli_mod.build_parser().parse_args(cli_args)
    base.ckpt, base.tokenizer = args.ckpt, args.tokenizer
    base.debug = args.debug
    base.quantize_llm = args.quantize_llm
    chat = cli_mod.build_chat(base)
    srv = make_server(chatwm_generate_fn(chat), port=args.port)
    print(f"[server] listening on :{args.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
