"""HTTP sidecar for browsing the control-plane store.

Counterpart of ``drl_tetris_tpu/cli/sidecar.py`` (reference:
tools/sidecar_app.py:8-28, a Flask app over Redis keys) on the standard
library and the port's ``KVClient``: GET / lists the keys, GET /key/<name>
returns a value, GET /stats the run's stats namespace, GET /alive the
heartbeating roles.

  python -m drl_tetris_tpu_torch.cli.sidecar --run-id myrun --port 8080
"""
from __future__ import annotations

import argparse
import html
import json
from http.server import BaseHTTPRequestHandler, HTTPServer

from drl_tetris_tpu_torch.runtime.kv import KVClient


def make_handler(kv: KVClient, run_id: str):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, body: str, ctype="text/html"):
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.startswith("/key/"):
                key = self.path[len("/key/"):]
                v = kv.get(key)
                self._send(json.dumps({
                    "key": key,
                    "value": None if v is None else v.decode("utf-8",
                                                             "replace"),
                    "bytes": 0 if v is None else len(v),
                }), "application/json")
                return
            if self.path == "/alive":
                alive = [k for k in kv.keys(run_id + "/")
                         if k.endswith("/alive")]
                self._send(json.dumps(sorted(alive)), "application/json")
                return
            if self.path == "/stats":
                out = {}
                for k in kv.keys(f"{run_id}/stats/"):
                    v = kv.get(k)
                    out[k] = None if v is None else v.decode("utf-8",
                                                             "replace")
                self._send(json.dumps(out, indent=1), "application/json")
                return
            rows = "".join(
                f'<li><a href="/key/{html.escape(k)}">{html.escape(k)}</a>'
                "</li>" for k in sorted(kv.keys("")))
            self._send(f"<h2>tetrikv — run {html.escape(run_id)}</h2>"
                       f"<p><a href='/alive'>alive</a> | "
                       f"<a href='/stats'>stats</a></p><ul>{rows}</ul>")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run-id", default="run")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--kv-port", type=int, default=6399)
    args = p.parse_args(argv)
    kv = KVClient(port=args.kv_port)
    server = HTTPServer(("127.0.0.1", args.port),
                        make_handler(kv, args.run_id))
    print(f"sidecar on http://127.0.0.1:{args.port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        kv.close()


if __name__ == "__main__":
    main()
