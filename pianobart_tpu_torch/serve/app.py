"""HTTP serving backend (pure-stdlib WSGI; ``pianobart_tpu/serve/app.py``).

Same surface as the JAX package's app and the reference Flask app
(``gui/backend/app.py``):

* ``GET  /``                          — minimal web UI (static/index.html)
* ``POST /api/upload``                — store a MIDI, render audio preview
* ``GET  /api/generate/<model>/<f>``  — continuation for an uploaded MIDI
* ``GET  /api/<folder>/<file>``       — artifact download
* ``GET  /api/health``                — liveness + model info

:class:`GenerationService` holds one model, loaded lazily and reused across
requests, and MICRO-BATCHES concurrent requests: a worker thread drains the
queue into one batched KV-cached decode on the card, with batch sizes
bucketed to powers of two.  :meth:`GenerationService.generate` takes a MIDI
file to a MIDI file (intro window, decode with per-request retries, cleaned
continuation).

Audio rendering shells out to FluidSynth when available; without it the
endpoints still serve MIDI.  Each model loads at its first use from its
checkpoint (a checkpoint directory of the port, or a reference
``.ckpt``/``.pth``; :func:`~..decode.load_inference_model`), or is drawn
from a seed when it has none.

``create_app`` returns a WSGI callable: host it with any WSGI server, or
``App.run()`` (wsgiref, threaded) for development.
"""
from __future__ import annotations

import json
import mimetypes
import os
import shutil
import subprocess
import threading
import time
import uuid
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .demo import midi_to_window, window_to_midi

__all__ = ["GenerationService", "App", "create_app", "parse_ckpt_registry"]

UPLOAD_DIR = "uploads"
OUTPUT_DIR = "outputs"
_STATIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


def _render_audio(midi_path: str, wav_path: str) -> bool:
    exe = shutil.which("fluidsynth")
    if not exe:
        return False
    try:
        subprocess.run([exe, "-ni", "-F", wav_path, midi_path],
                       check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _parse_multipart_file(environ, field: str) -> Tuple[str, bytes]:
    """Minimal multipart/form-data parser for one file field (the stdlib
    ``cgi`` module is deprecated/removed in newer Pythons)."""
    ctype = environ.get("CONTENT_TYPE", "")
    if "multipart/form-data" not in ctype or "boundary=" not in ctype:
        raise ValueError("expected multipart/form-data")
    boundary = ctype.split("boundary=", 1)[1].split(";")[0].strip().strip('"')
    length = int(environ.get("CONTENT_LENGTH") or 0)
    body = environ["wsgi.input"].read(length)
    delim = b"--" + boundary.encode()
    for part in body.split(delim):
        if b"\r\n\r\n" not in part:
            continue
        header, _, payload = part.partition(b"\r\n\r\n")
        htext = header.decode("latin-1", errors="replace")
        if f'name="{field}"' not in htext or "filename=" not in htext:
            continue
        filename = htext.split("filename=", 1)[1].split("\r\n")[0].strip().strip('"')
        if not filename:
            continue
        # exactly ONE trailing CRLF belongs to the boundary delimiter; the
        # closing '--' lands in the NEXT split element, so a binary upload
        # ending in 0x0d/0x0a/'--' keeps those bytes
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        return filename, payload
    raise ValueError("no file")


class _Pending:
    """One queued generation request."""

    __slots__ = ("intro", "seed", "event", "result", "error", "served_n")

    def __init__(self, intro, seed):
        self.intro = intro
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.served_n = 1  # batch size this request was served in


def _batch_seed(seeds: List[int]) -> int:
    """One seed for the batch-level sampling stream, folded from the request
    seeds in order (a batch of one keeps its request's seed)."""
    s = int(seeds[0])
    for x in seeds[1:]:
        s = (s * 1_000_003 + int(x)) % (1 << 63)
    return s


class GenerationService:
    """Holds the model, loaded lazily, reused across calls.

    ``model`` defaults to a ``PianoBartLM`` of ``cfg`` (the flagship with
    bf16 weights by default) loaded from ``ckpt`` at first use, or with
    random weights from ``seed`` without one; ``device`` defaults to CUDA
    and raises without it.  ``generate_fn(midi_in, midi_out, seed) -> ok``
    replaces the whole MIDI path (a test hook, as in the JAX package).
    """

    def __init__(self, model=None, cfg=None, device: DeviceLike = None,
                 seed: int = 0, max_batch: int = 8,
                 batch_window_s: float = 0.02,
                 generate_fn: Optional[Callable] = None,
                 ckpt: Optional[str] = None):
        self.device = resolve_device(device)
        self.ckpt = ckpt
        self._generate_fn = generate_fn
        self.model = model
        self._cfg_arg = cfg  # None -> flagship dims in bf16
        self.seed = seed
        self._ready = model is not None
        self.cfg = None if model is None else model.cfg
        self._lock = threading.Lock()
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._cond = threading.Condition()
        self._queue: list = []
        self._worker: Optional[threading.Thread] = None
        self.batch_sizes_served: list = []  # observability / tests

    def _ensure(self):
        if self._ready or self._generate_fn is not None:
            return
        with self._lock:
            if self._ready:
                return
            from ..decode import load_inference_model
            from ..models.config import PianoBartConfig
            # serving holds bf16 weights: the decode step then casts nothing
            self.cfg = self._cfg_arg or PianoBartConfig(
                dtype=torch.bfloat16, param_dtype=torch.bfloat16)
            try:
                self.model = load_inference_model(self.cfg, self.ckpt, self.seed,
                                                  self.device)
            except SystemExit as exc:   # a refused checkpoint: the App's 500
                raise RuntimeError(str(exc)) from None
            self._ready = True

    @property
    def ready(self) -> bool:
        return self._ready

    def _bucket_of(self, n: int) -> int:
        """Decode batch-shape bucket for a drain of n requests: the next
        power of two, so at most log2(max_batch)+1 shapes ever run."""
        bucket = 1
        while bucket < n:
            bucket *= 2
        return bucket

    def warmup(self, buckets=None) -> dict:
        """Run one decode at every reachable bucket shape before the first
        live request: it builds the flash kernel and fills the CUDA caching
        allocator and the matmul heuristics at each shape.  Returns
        {bucket: seconds}; nothing to warm behind a ``generate_fn``."""
        if self._generate_fn is not None:
            return {}
        self._ensure()
        if buckets is None:
            # exactly the shapes the worker's drain can produce
            buckets = sorted({self._bucket_of(n)
                              for n in range(1, self.max_batch + 1)})
        timings = {}
        for b in buckets:
            intros = np.zeros((b, self.cfg.max_len, 8), dtype=np.int64)
            t0 = time.time()
            self._decode_batch(intros, list(range(b)))
            timings[int(b)] = round(time.time() - t0, 3)
        return timings

    def generate(self, midi_in: str, midi_out: str,
                 seed: int = 0) -> Tuple[bool, dict]:
        """MIDI file -> continuation MIDI file.  Returns (ok, info): ok is
        False when every attempt came back empty; info carries the served
        batch size, the seed's semantics under micro-batching and the
        number of decode attempts."""
        if self._generate_fn is not None:
            return bool(self._generate_fn(midi_in, midi_out, seed)), {}
        self._ensure()
        intro = np.asarray(midi_to_window(midi_in, self.cfg.max_len))[0]
        # A sampled first token outside the legal range yields an empty
        # continuation (the reference one-shots this and prints "Generate
        # Fail!", demo.py:102).  Retry per REQUEST: each retry re-enters the
        # micro-batch queue with a distinct seed, so it can coalesce with
        # live traffic.
        retries = max(1, int(os.environ.get("PBX_DEMO_RETRIES", "4")))
        ok = False
        for attempt in range(retries):
            req = self._submit_req(intro, seed + attempt)
            ok = window_to_midi(np.asarray(req.result), midi_out)
            if ok:
                break
        info = {
            "batch_size_served": req.served_n,
            "seed_semantics": ("per-request" if req.served_n == 1 else
                               f"batch-level stream over {req.served_n} "
                               f"coalesced requests"),
            # every decode attempt, the last included: exhausting the
            # retries reports attempts == PBX_DEMO_RETRIES with ok False
            "attempts": attempt + 1,
            "retries": attempt,
        }
        return ok, info

    # -- micro-batching queue -------------------------------------------------

    def submit(self, intro_window, seed: int = 0):
        """Enqueue one (S, 8) intro; blocks until its continuation is ready.

        Thread-safe; concurrent submitters are served by ONE batched decode.
        Outputs are sampled from a batch-level stream, so per-request seed
        reproducibility holds only for a batch of one.
        """
        return self._submit_req(intro_window, seed).result

    def _submit_req(self, intro_window, seed: int = 0) -> _Pending:
        req = _Pending(intro_window, seed)
        with self._cond:
            self._queue.append(req)
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._worker_loop,
                                                daemon=True)
                self._worker.start()
            self._cond.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req

    def _decode_batch(self, intros, seeds):
        """(B, S, 8) intros -> (B, S, 8) continuations as numpy."""
        self._ensure()
        from ..decode import generate
        gen = torch.Generator(device=self.device).manual_seed(_batch_seed(seeds))
        out = generate(self.model, intros, generator=gen, device=self.device)
        return out.cpu().numpy()

    def _worker_loop(self):
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
            # small gathering window lets concurrent requests coalesce
            time.sleep(self.batch_window_s)
            with self._cond:
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
            if not batch:
                continue
            try:
                n = len(batch)
                bucket = self._bucket_of(n)  # bounded set of batch shapes
                intros = np.stack([r.intro for r in batch]
                                  + [batch[-1].intro] * (bucket - n))
                seeds = [r.seed for r in batch]
                outs = self._decode_batch(intros, seeds)
                self.batch_sizes_served.append(n)
                for r, o in zip(batch, outs[:n]):
                    r.result = o
                    r.served_n = n
            except BaseException as exc:  # deliver, don't kill the worker
                for r in batch:
                    r.error = exc
            finally:
                for r in batch:
                    r.event.set()


class App:
    """Minimal WSGI application with the reference's route table.

    ``services`` is a registry of named models ({name: GenerationService});
    the ``<model>`` segment of ``/api/generate/<model>/<file>`` selects one.
    A single service registers as ``pianobart`` (the reference frontend's
    default model name).  Uploads and outputs live under the working
    directory."""

    def __init__(self, services, ckpt: Optional[str] = None):
        if isinstance(services, GenerationService):   # single-model shorthand
            services = {"pianobart": services}
        self.services = services
        self.ckpt = ckpt
        self.server = None      # the running server of run(), for shutdown()
        os.makedirs(UPLOAD_DIR, exist_ok=True)
        os.makedirs(OUTPUT_DIR, exist_ok=True)

    # -- WSGI ---------------------------------------------------------------
    def __call__(self, environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")
        try:
            status, headers, body = self.route(method, path, environ)
        except Exception as exc:  # the server answers 500 and keeps running
            status, headers, body = self._json(500, {"error": str(exc)})
        start_response(status, headers)
        return [body]

    def _json(self, code: int, obj) -> Tuple[str, list, bytes]:
        body = json.dumps(obj).encode()
        codes = {200: "200 OK", 400: "400 Bad Request", 404: "404 Not Found",
                 500: "500 Internal Server Error"}
        return codes[code], [("Content-Type", "application/json"),
                             ("Content-Length", str(len(body)))], body

    def _file(self, root: str, name: str) -> Tuple[str, list, bytes]:
        path = os.path.join(root, os.path.basename(name))
        if not os.path.exists(path):
            return self._json(404, {"error": "not found"})
        with open(path, "rb") as f:
            body = f.read()
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        return "200 OK", [("Content-Type", ctype),
                          ("Content-Length", str(len(body)))], body

    # -- routes ---------------------------------------------------------------
    def route(self, method: str, path: str, environ) -> Tuple[str, list, bytes]:
        if method == "GET" and path in ("/", "/index.html"):
            return self._file(_STATIC, "index.html")
        if method == "GET" and path == "/api/health":
            return self._json(200, {
                "status": "ok", "ckpt": self.ckpt,
                "model_loaded": any(s.ready for s in self.services.values()),
                "models": {name: {"ckpt": s.ckpt, "loaded": s.ready}
                           for name, s in self.services.items()}})
        if method == "POST" and path == "/api/upload":
            return self.upload(environ)
        if method == "GET" and path.startswith("/api/generate/"):
            parts = path[len("/api/generate/"):].split("/", 1)
            if len(parts) != 2:
                return self._json(404, {"error": "bad generate path"})
            return self.generate(parts[0], parts[1])
        if method == "GET" and path.startswith("/api/"):
            parts = path[len("/api/"):].split("/", 1)
            if len(parts) == 2:
                root = {"uploads": UPLOAD_DIR, "outputs": OUTPUT_DIR}.get(parts[0])
                if root is None:
                    return self._json(404, {"error": "unknown folder"})
                return self._file(root, parts[1])
        return self._json(404, {"error": "no such route"})

    def upload(self, environ) -> Tuple[str, list, bytes]:
        try:
            filename, data = _parse_multipart_file(environ, field="file")
        except ValueError as exc:
            return self._json(400, {"error": str(exc)})
        name = f"{uuid.uuid4().hex[:8]}_{os.path.basename(filename)}"
        path = os.path.join(UPLOAD_DIR, name)
        with open(path, "wb") as f:
            f.write(data)
        wav = path.rsplit(".", 1)[0] + ".wav"
        audio = _render_audio(path, wav)
        return self._json(200, {"file": name,
                                "audio": os.path.basename(wav) if audio else None})

    def generate(self, model: str, fname: str) -> Tuple[str, list, bytes]:
        service = self.services.get(model)
        if service is None:
            return self._json(404, {"error": f"unknown model '{model}'",
                                    "models": sorted(self.services)})
        src = os.path.join(UPLOAD_DIR, os.path.basename(fname))
        if not os.path.exists(src):
            return self._json(404, {"error": "not uploaded"})
        # the model name in the output path: two models generating from the
        # same upload must not overwrite each other's MIDI/WAV
        out_name = f"gen_{model}_{os.path.basename(fname)}"
        out = os.path.join(OUTPUT_DIR, out_name)
        t0 = time.time()
        ok, info = service.generate(src, out)
        if not ok:
            return self._json(500, {"error": "generation produced no notes"})
        wav = out.rsplit(".", 1)[0] + ".wav"
        audio = _render_audio(out, wav)
        return self._json(200, {"file": out_name, "model": model,
                                "audio": os.path.basename(wav) if audio else None,
                                "latency_s": round(time.time() - t0, 3),
                                **info})

    def run(self, host: str = "0.0.0.0", port: int = 5000) -> None:
        """Serve until ``shutdown()``.  Threaded: concurrent requests must
        overlap to reach the micro-batching queue together (wsgiref's
        default server is single-threaded)."""
        import socketserver
        from wsgiref.simple_server import WSGIServer, make_server

        class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
            daemon_threads = True

        with make_server(host, port, self,
                         server_class=ThreadingWSGIServer) as srv:
            self.server = srv
            print(f"pianobart_tpu_torch serving on http://{host}:{srv.server_port}")
            srv.serve_forever()

    def shutdown(self) -> None:
        """Stop a ``run()`` started in another thread."""
        if self.server is not None:
            self.server.shutdown()


def parse_ckpt_registry(entries) -> dict:
    """CLI --ckpt entries -> {name: path}: "name=path" registers a named
    model; a bare path registers as "pianobart" (the reference frontend's
    default model name).  Duplicate names are an error.

    A '=' only splits when the left side looks like a model NAME (no path
    separator): ``--ckpt result/lr=1e-3/best`` is a bare path with '=' in a
    directory name, not a registration of model "result/lr"."""
    ckpts: dict = {}
    for entry in entries or []:
        name, sep, path = entry.partition("=")
        if sep and name and os.sep not in name and "/" not in name:
            pass                       # explicit name=path registration
        else:
            name, path = "pianobart", entry
        if name in ckpts:
            raise SystemExit(f"duplicate model name '{name}' in --ckpt")
        ckpts[name] = path
    return ckpts or {"pianobart": None}


def create_app(ckpt: Optional[str] = None,
               generate_fn: Optional[Callable] = None,
               ckpts: Optional[dict] = None,
               max_batch: int = 8, batch_window_s: float = 0.02,
               device: DeviceLike = None, cfg=None) -> App:
    """``ckpts``: {name: path} registry; ``ckpt``: a single checkpoint
    registered as ``pianobart``.  Each path (or ``None``: random weights
    from ``GenerationService``'s default seed) loads at the model's first
    use, with ``cfg`` (``GenerationService``'s default when ``None``).
    ``generate_fn`` (tests) applies to every registered model; ``device``
    defaults to CUDA and raises without it."""
    if ckpts is None:
        ckpts = {"pianobart": ckpt}
    services = {
        name: GenerationService(cfg=cfg, device=device, ckpt=path,
                                generate_fn=generate_fn, max_batch=max_batch,
                                batch_window_s=batch_window_s)
        for name, path in ckpts.items()}
    return App(services, ckpt if ckpt is not None
               else next(iter(ckpts.values()), None))
