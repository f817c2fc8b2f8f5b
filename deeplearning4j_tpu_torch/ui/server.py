"""Training-visualization web UI server.

Port of ``deeplearning4j_tpu/ui/server.py``, the equivalent of the
reference's Dropwizard UI
(`deeplearning4j-ui/.../UiServer.java` (242) and its Jersey resources:
`api/ApiResource.java`, `weights/WeightResource.java`,
`activation/ActivationsResource.java`, `flow/FlowResource.java`,
`tsne/TsneResource.java`, `nearestneighbors/NearestNeighborsResource.java`,
`renders/RendersResource.java`). A dependency-free
stdlib ``ThreadingHTTPServer`` serving JSON endpoints plus a single-page
dashboard (inline JS/canvas — no external assets, zero-egress friendly).
Training listeners (see ``ui/listeners.py``) POST snapshots exactly the way
the reference's ``HistogramIterationListener`` POSTs ``ModelAndGradient`` to
``/weights/update?sid=``.

Endpoints (all JSON unless noted):
  POST /weights/update?sid=S        model+gradient histograms  (WeightResource)
  GET  /weights/data?sid=S          latest snapshot
  GET  /weights/history?sid=S&last=N  score/norm history
  POST /activations/update?sid=S    activation tile image (base64 PNG)
  GET  /activations/data?sid=S
  POST /flow/update?sid=S           architecture flowchart     (FlowResource)
  GET  /flow/data?sid=S
  POST /tsne/upload?sid=S           2-d coords + labels        (TsneResource)
  GET  /tsne/coords?sid=S
  POST /nearestneighbors/upload     {labels: [...], vectors: [[...]]}
  GET  /nearestneighbors?word=w&k=5 VPTree k-NN                (NearestNeighborsResource)
  POST /api/update?sid=S            free-form payload          (ApiResource)
  GET  /api/data?sid=S
  POST /renders/update              {path: ...} repoint render (RendersResource)
  GET  /renders/img                 current render PNG (auto-tracks the
                                    latest activation tile)
  POST /uploads/upload              {filename, content_b64}    (FileResource)
  GET  /uploads/<name>              serve an uploaded file back
  GET  /sessions                    known session ids
  GET  /                            dashboard (text/html)
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.ui.storage import HistoryStorage, SessionStorage

_DEFAULT_SID = "default"


class UiServer:
    """Singleton UI server (UiServer.getInstance(), UiServer.java:242)."""

    _instance: Optional["UiServer"] = None
    _instance_lock = threading.Lock()

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.storage = SessionStorage()
        self.history = HistoryStorage()
        self._nn_lock = threading.Lock()
        self._nn_labels: List[str] = []
        self._nn_vectors: Optional[np.ndarray] = None
        self._nn_tree = None
        # renders (RendersResource.java:43): the latest activation tile
        # is kept as in-memory PNG bytes (no per-iteration disk write);
        # POST /renders/update can repoint at a file, but ONLY inside
        # upload_dir — the reference allowed any path, which on a
        # non-localhost bind is an arbitrary-file-read hole
        self._render_bytes: Optional[bytes] = None
        self.render_path: Optional[str] = None
        # uploads land in a per-server temp dir (FileResource.java:45
        # defaults to java.io.tmpdir); upload_handler mirrors the
        # abstract handleUpload(File) hook (FileResource.java:111)
        self.upload_dir = tempfile.mkdtemp(prefix="dl4j_tpu_ui_uploads_")
        self.upload_handler = None  # Optional[Callable[[str], None]]
        server = self  # close over for the handler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, payload: Any, status: int = 200,
                      content_type: str = "application/json") -> None:
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    server._get(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface handler bugs to the client
                    self._send({"error": repr(e)}, status=500)

            def do_POST(self):
                try:
                    server._post(self)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    self._send({"error": repr(e)}, status=500)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dl4j-tpu-ui", daemon=True)
        self._thread.start()

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def get_instance(cls, port: int = 0) -> "UiServer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = UiServer(port=port)
            return cls._instance

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        import shutil

        self._httpd.shutdown()
        self._httpd.server_close()
        shutil.rmtree(self.upload_dir, ignore_errors=True)
        with UiServer._instance_lock:
            if UiServer._instance is self:
                UiServer._instance = None

    # -- direct (in-process) ingestion ---------------------------------
    def post_update(self, kind: str, payload: Any,
                    sid: str = _DEFAULT_SID) -> None:
        self.storage.put(sid, kind, payload)
        if kind == "weights":
            self.history.append(sid, "weights", _weights_history_row(payload))
        else:
            self.history.append(sid, kind, payload)
        if kind == "activations":
            self._capture_render(payload)

    def _capture_render(self, payload: Any) -> None:
        """Keep the listener's latest conv-activation tile as in-memory
        PNG bytes so /renders/img serves it with zero disk I/O
        (RendersResource parity without the reference's file round-trip)."""
        img = (payload or {}).get("image", "")
        marker = ";base64,"
        if not isinstance(img, str) or marker not in img:
            return
        try:
            self._render_bytes = base64.b64decode(img.split(marker, 1)[1])
        except (ValueError, IndexError):
            pass

    def _resolve_upload(self, path: str) -> Optional[str]:
        """realpath-confine ``path`` to upload_dir; None if it escapes."""
        real = os.path.realpath(
            path if os.path.isabs(path)
            else os.path.join(self.upload_dir, path))
        root = os.path.realpath(self.upload_dir)
        return real if real.startswith(root + os.sep) else None

    def upload_vectors(self, labels: List[str], vectors) -> None:
        """Load word vectors for the nearest-neighbors endpoint."""
        from deeplearning4j_tpu_torch.clustering.vptree import VPTree

        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or len(labels) != vectors.shape[0]:
            raise ValueError("labels and vectors must align")
        with self._nn_lock:
            self._nn_labels = list(labels)
            self._nn_vectors = vectors
            self._nn_tree = VPTree(vectors)

    def nearest(self, word: str, k: int = 5) -> List[Dict[str, Any]]:
        with self._nn_lock:
            tree, labels, vecs = self._nn_tree, self._nn_labels, self._nn_vectors
        if tree is None:
            return []
        if word not in labels:
            return []
        idx = labels.index(word)
        hits = tree.knn(vecs[idx], k + 1)
        return [{"word": labels[i], "distance": float(d)}
                for i, d in hits if i != idx][:k]

    # -- request routing -----------------------------------------------
    def _get(self, h) -> None:
        parsed = urlparse(h.path)
        q = parse_qs(parsed.query)
        sid = q.get("sid", [_DEFAULT_SID])[0]
        route = parsed.path.rstrip("/") or "/"
        if route == "/":
            h._send(_DASHBOARD_HTML.encode(), content_type="text/html")
        elif route == "/sessions":
            h._send(self.storage.sessions())
        elif route == "/weights/data":
            h._send(self.storage.get(sid, "weights") or {})
        elif route == "/weights/history":
            last = int(q.get("last", ["0"])[0])
            h._send([row["payload"]
                     for row in self.history.get(sid, "weights", last)])
        elif route == "/activations/data":
            h._send(self.storage.get(sid, "activations") or {})
        elif route == "/flow/data":
            h._send(self.storage.get(sid, "flow") or {})
        elif route == "/tsne/coords":
            h._send(self.storage.get(sid, "tsne") or {})
        elif route == "/api/data":
            h._send(self.storage.get(sid, "api") or {})
        elif route == "/nearestneighbors":
            word = q.get("word", [""])[0]
            k = int(q.get("k", ["5"])[0])
            h._send(self.nearest(word, k))
        elif route == "/renders/img":
            # serve the current render image (RendersResource.java:54-57
            # GET /filters/img): the latest activation tile from memory,
            # unless POST /renders/update repointed at an uploaded file
            if self.render_path is not None:
                path = self._resolve_upload(self.render_path)
                if path is None or not os.path.isfile(path):
                    h._send({"error": "no render at the configured path"},
                            status=404)
                else:
                    with open(path, "rb") as f:
                        h._send(f.read(), content_type="image/png")
            elif self._render_bytes is not None:
                h._send(self._render_bytes, content_type="image/png")
            else:
                h._send({"error": "no render yet"}, status=404)
        elif route.startswith("/uploads/"):
            # GET /uploads/<name> serves an uploaded file back
            # (FileResource.java:47-50 GET /{path})
            name = os.path.basename(route[len("/uploads/"):])
            target = os.path.join(self.upload_dir, name)
            if not name or not os.path.isfile(target):
                h._send({"error": "not found"}, status=404)
            else:
                with open(target, "rb") as f:
                    h._send(f.read(),
                            content_type="application/octet-stream")
        else:
            h._send({"error": "not found"}, status=404)

    def _post(self, h) -> None:
        parsed = urlparse(h.path)
        q = parse_qs(parsed.query)
        sid = q.get("sid", [_DEFAULT_SID])[0]
        length = int(h.headers.get("Content-Length", "0"))
        payload = json.loads(h.rfile.read(length) or b"{}")
        route = parsed.path.rstrip("/")
        kinds = {"/weights/update": "weights",
                 "/activations/update": "activations",
                 "/flow/update": "flow",
                 "/tsne/upload": "tsne",
                 "/api/update": "api"}
        if route in kinds:
            self.post_update(kinds[route], payload, sid=sid)
            h._send({"status": "ok"})
        elif route == "/nearestneighbors/upload":
            self.upload_vectors(payload["labels"], payload["vectors"])
            h._send({"status": "ok", "count": len(payload["labels"])})
        elif route == "/renders/update":
            # {"path": "..."} repoints the render image
            # (RendersResource.java:45-49 POST /filters/update). The path
            # must resolve inside upload_dir (upload the file first via
            # /uploads/upload); anything else is rejected — the reference
            # accepted arbitrary paths, which is a file-read hole on a
            # non-localhost bind. {"path": null} reverts to the live
            # activation-tile bytes.
            raw = payload.get("path")
            if raw is None:
                self.render_path = None
                h._send({"status": "ok", "path": None})
                return
            resolved = self._resolve_upload(str(raw))
            if resolved is None:
                h._send({"error": "path must be inside the upload dir"},
                        status=403)
                return
            self.render_path = resolved
            h._send({"status": "ok", "path": resolved})
        elif route == "/uploads/upload":
            # JSON {"filename": ..., "content_b64": ...} — the stdlib
            # server speaks JSON, not multipart; the semantics match
            # FileResource.java:78-88 (write under the upload dir, fire
            # the handler, echo the landed location)
            name = os.path.basename(str(payload.get("filename", "")))
            if not name:
                h._send({"error": "filename required"}, status=400)
                return
            try:
                # validate=True: reject (not silently drop) stray chars,
                # so the stored bytes are exactly what the client sent
                data = base64.b64decode(str(payload.get("content_b64", "")),
                                        validate=True)
            except (binascii.Error, ValueError) as e:
                h._send({"error": f"invalid base64 content: {e}"},
                        status=400)
                return
            target = os.path.join(self.upload_dir, name)
            with open(target, "wb") as f:
                f.write(data)
            if self.upload_handler is not None:
                self.upload_handler(target)
            h._send({"status": "ok", "path": target, "bytes": len(data)})
        else:
            h._send({"error": "not found"}, status=404)


def _weights_history_row(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Compact history row from a full weights snapshot."""
    row = {"iteration": payload.get("iteration"),
           "score": payload.get("score")}
    norms = {}
    for name, stats in (payload.get("parameters") or {}).items():
        norms[name] = stats.get("l2")
    row["param_l2"] = norms
    return row


_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu-dl4j training UI</title>
<style>
 body{font-family:sans-serif;margin:1.2em;background:#fafafa;color:#222}
 h1{font-size:1.3em} h2{font-size:1.05em;margin:0.4em 0}
 .card{background:#fff;border:1px solid #ddd;border-radius:6px;
       padding:0.8em;margin:0.8em 0}
 canvas{border:1px solid #eee;background:#fff}
 .bars div{display:inline-block;width:8px;background:#4a7dbd;
           margin-right:1px;vertical-align:bottom}
 select{margin-left:0.6em}
 img{image-rendering:pixelated;border:1px solid #eee}
 pre{white-space:pre-wrap}
</style></head><body>
<h1>tpu-dl4j training UI</h1>
<label>session<select id="sid"></select></label>
<div class="card"><h2>score</h2><canvas id="score" width="640" height="160">
</canvas></div>
<div class="card"><h2>parameter histograms</h2><div id="hist"></div></div>
<div class="card"><h2>architecture</h2><pre id="flow"></pre></div>
<div class="card"><h2>activations</h2><div id="act"></div></div>
<script>
const $=id=>document.getElementById(id);
async function j(u){const r=await fetch(u);return r.json();}
async function sessions(){
  const s=await j('/sessions');const sel=$('sid');
  const cur=sel.value;sel.innerHTML='';
  s.forEach(x=>{const o=document.createElement('option');o.textContent=x;
    sel.appendChild(o);});
  if(s.includes(cur))sel.value=cur;
}
function drawScore(hist){
  const c=$('score'),ctx=c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  const pts=hist.filter(r=>r.score!=null);
  if(!pts.length)return;
  const xs=pts.map((_,i)=>i),ys=pts.map(r=>r.score);
  const ymin=Math.min(...ys),ymax=Math.max(...ys),pad=8;
  ctx.strokeStyle='#4a7dbd';ctx.beginPath();
  pts.forEach((r,i)=>{
    const x=pad+(c.width-2*pad)*i/Math.max(1,pts.length-1);
    const y=c.height-pad-(c.height-2*pad)*((r.score-ymin)/Math.max(1e-12,ymax-ymin));
    i?ctx.lineTo(x,y):ctx.moveTo(x,y);});
  ctx.stroke();
  ctx.fillStyle='#555';
  ctx.fillText(ymax.toPrecision(4),2,10);
  ctx.fillText(ymin.toPrecision(4),2,c.height-2);
}
function drawHists(data){
  const host=$('hist');host.innerHTML='';
  const params=data.parameters||{};
  Object.keys(params).forEach(name=>{
    const st=params[name];const div=document.createElement('div');
    const bars=(st.histogram&&st.histogram.counts)||[];
    const mx=Math.max(1,...bars);
    div.innerHTML='<b>'+name+'</b> mean='+(+st.mean).toPrecision(3)+
      ' std='+(+st.std).toPrecision(3)+' l2='+(+st.l2).toPrecision(3)+
      '<br><span class="bars">'+
      bars.map(b=>'<div style="height:'+(2+30*b/mx)+'px"></div>').join('')+
      '</span>';
    host.appendChild(div);});
}
async function tick(){
  await sessions();
  const sid=$('sid').value||'default';
  const hist=await j('/weights/history?sid='+sid);
  drawScore(hist);
  drawHists(await j('/weights/data?sid='+sid));
  const flow=await j('/flow/data?sid='+sid);
  $('flow').textContent=JSON.stringify(flow,null,1);
  const act=await j('/activations/data?sid='+sid);
  $('act').innerHTML=act.image?'<img src="'+act.image+'" width="420">':'';
}
setInterval(tick,2000);tick();
</script></body></html>
"""
