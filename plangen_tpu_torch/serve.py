"""Inference server: an HTTP front and a microbatching back on one card.

Port of `plangen_tpu/serve.py`, with the same endpoints, JSON, 400s,
buckets and seed contract:

  * Requests queue up and are drained into microbatches padded to a fixed
    set of batch buckets (1, 2, 4, ..., max_batch). Padding rows reuse the
    first request's prompt and are dropped from responses.
  * A PREP thread drains the queue and builds each batch on the host
    (tokenization, the CFG dual batch: the pipeline's `host_*` halves)
    while the device works on the batch before it. HTTP handler threads
    decode PNGs and rasterize edit boxes at submit time. None of these
    threads makes a CUDA call.
  * ONE device-owner thread makes every CUDA call: the pipeline's
    `embed_*` halves (embeds, SigLIP, the VQ encode), the decode loops and
    their CUDA graph captures, and the VQ decode. A capture must see no
    other thread's device work, and the kernel wrappers' launch counts,
    which a capture reads before and after, must see no other thread's
    launches.
  * An assembler pool encodes each batch's PNGs and builds its responses,
    overlapped with the next batch: the owner enqueues the pixels' copy
    to pinned host memory and records an event (`pipe.defer_fetch`), and
    the assembler waits on that event, its one CUDA call.

Endpoints (JSON in/out):
  POST /generate   {"caption": str, "grounding": str, "seed"?: int,
                    "parallel_size"?: int}
                   -> {"image_b64": png, "images_b64": [png x ps],
                       "tokens": [...], "seed": int}
  POST /plan       {"caption": str} -> {"grounding": str}
  POST /joint      {"caption": str, "seed"?: int, "parallel_size"?: int}
                   -> {"grounding", "image_b64", "images_b64", "seed"}
  POST /understand {"image_b64": png, "question"?: str} -> {"grounding": str}
  POST /edit       {"caption"?, "grounding": str, "image_b64": png,
                    "edit_region": [576 ints, 1 = regenerate] OR
                    "edit_boxes": [[x1,y1,x2,y2] normalized, ...]
                    (+ optional "pad_edit_box" dilation fraction),
                    "neg_grounding"?: str (removal), "seed"?: int}
                   -> {"image_b64": png, "tokens": [...], "seed": int}
  GET  /healthz    -> {"ok": true, "stats": {...}}

Input images (`image_b64`) are read as the JAX server reads them: any
format Pillow reads (PNG of any depth, palette or interlacing, JPEG, ...),
converted to RGB and resized to the model's size with Pillow's bicubic
filter; an image Pillow cannot read is a 400.

Seed contract: a request with "seed" samples from its own generators
(`pipeline.row_generators`), so on the CPU its tokens are a pure function
of (inputs, seed) whatever shares its batch. On the card they are such a
function within one bucket; across buckets the bf16 matmuls of different
row counts may round apart, and so may the tokens. Seedless requests draw
a random 31-bit seed, echoed in the response "seed" field.
`parallel_size` (default 1) samples that many images from one prompt;
`images_b64` lists them and `image_b64` / `tokens` keep the first.

Run: python -m plangen_tpu_torch.cli serve --opt ... --port 8000
"""

from __future__ import annotations

import base64
import io
import json
import queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from plangen_tpu_torch.data.preprocess import build_edit_region
from plangen_tpu_torch.utils.visualize import encode_png

MODES = ("generate", "plan", "joint", "understand", "edit")


def _png_b64(image: np.ndarray) -> str:
    return base64.b64encode(encode_png(image)).decode()


def _png_decode(b64: str, hw: int) -> np.ndarray:
    """base64 image (any format Pillow reads) -> [hw, hw, 3] float32 in
    [-1, 1]: RGB, then Pillow's bicubic resize, the reference
    preprocessor's resample, as the JAX server does."""
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64, validate=True))).convert("RGB")
    img = img.resize((hw, hw), Image.BICUBIC)
    return np.asarray(img).astype(np.float32) / 127.5 - 1.0


@dataclass
class _Request:
    mode: str
    payload: Dict[str, Any]
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    # decoded input image (understand / edit), made at submit() on the HTTP
    # handler thread: a bad image_b64 fails only its own request (400)
    pixels: Optional[np.ndarray] = None


class Batcher:
    """Drains the queue into per-mode microbatches: a prep thread builds each
    on the host, the device-owner thread runs it (module docstring).

    Batch sizes snap up to the nearest bucket (1, 2, 4, ..., max_batch), so
    each (mode, bucket) is one shape; `wait_ms` bounds the extra latency a
    request pays for batching, `min_batch` floors the bucket."""

    BUCKETS = (1, 2, 4, 8, 16, 32, 64)

    def __init__(self, pipeline, max_batch: int = 32, wait_ms: float = 20.0,
                 min_batch: int = 1):
        if not 1 <= min_batch <= max_batch:
            raise ValueError(f"min_batch must be in [1, max_batch={max_batch}], "
                             f"got {min_batch}")
        self.pipe = pipeline
        self.max_batch = max_batch
        self.min_batch = min_batch
        self.wait_s = wait_ms / 1000.0
        self.q: "queue.Queue[_Request]" = queue.Queue()
        # prep_s: host batch builds on the prep thread; device_s: the
        # device-owner's time in _execute (device prep, decode, the enqueued
        # fetch); assembly_s: PNG encoding and responses, overlapped with
        # the next batch; idle_s: the owner's time between batches
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "prep_s": 0.0, "device_s": 0.0, "assembly_s": 0.0,
                      "idle_s": 0.0}
        self._stats_lock = threading.Lock()
        self._last_run_end: Optional[float] = None
        self._png_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="plangen-png")
        # separate from the PNG pool: assemblers wait on PNG futures, so one
        # shared pool could fill with waiting assemblers and deadlock
        self._asm_pool = ThreadPoolExecutor(max_workers=2,
                                            thread_name_prefix="plangen-assemble")
        # each deferred batch pins its pixels until assembly reads them: at
        # most two in flight, the owner blocks here beyond that
        self._defer_sem = threading.Semaphore(2)
        self._held: Optional[_Request] = None  # first request of the next batch
        # device occupancy and EMA durations for the drain deadline: while
        # the device is busy a fuller batch costs no extra latency
        self._exec_busy = threading.Event()
        self._exec_start = 0.0
        self._ema_dev = 0.0
        self._ema_prep = 0.0
        self._stop = threading.Event()
        # one built batch at most waits for the device
        self._ready: "queue.Queue" = queue.Queue(maxsize=1)
        self._prep_thread = threading.Thread(target=self._prep_loop, daemon=True,
                                             name="plangen-prep")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="plangen-batcher")
        self._prep_thread.start()
        self._thread.start()

    def _edit_region(self, payload: Dict[str, Any]) -> np.ndarray:
        """The edit region from a raw token-grid mask ("edit_region", 576
        ints) or normalized boxes ("edit_boxes" [[x1, y1, x2, y2], ...],
        optional "pad_edit_box"). Runs at submit(): a malformed one raises
        ValueError there (a 400 for this request only)."""
        n_img = self.pipe.cfg.image_seq_len
        if "edit_boxes" in payload and "edit_region" not in payload:
            boxes = np.asarray(payload["edit_boxes"], dtype=np.float32)
            if boxes.size % 4 != 0:
                raise ValueError(f"edit_boxes must be [N, 4] normalized coords, "
                                 f"got {boxes.shape}")
            return build_edit_region(
                boxes, grid=self.pipe.grid,
                pad_edit_box=float(payload.get("pad_edit_box", 0.0)),
            ).astype(np.int32)
        if "edit_region" not in payload:
            raise ValueError("edit needs 'edit_region' (or 'edit_boxes')")
        reg = np.asarray(payload["edit_region"], dtype=np.int32)
        if reg.shape != (n_img,):
            raise ValueError(f"edit_region must have {n_img} entries, got {reg.shape}")
        return reg

    def submit(self, mode: str, payload: Dict[str, Any]) -> _Request:
        """Validate a request (ValueError / TypeError: a 400) and queue it."""
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        req = _Request(mode, payload)
        self._req_seed(req)
        ps = self._req_ps(req)
        if ps > 1 and mode not in ("generate", "joint"):
            raise ValueError(f"parallel_size applies to generate/joint, not {mode}")
        if ps > self.max_batch:
            raise ValueError(f"parallel_size {ps} exceeds this server's max_batch "
                             f"{self.max_batch} image rows")
        if mode in ("generate", "joint", "plan") and not isinstance(
                payload.get("caption"), str):
            raise ValueError(f"{mode} request requires a string 'caption'")
        if mode in ("generate", "edit") and not isinstance(payload.get("grounding"), str):
            raise ValueError(f"{mode} request requires a string 'grounding'")
        if mode in ("understand", "edit"):
            try:
                req.pixels = _png_decode(payload["image_b64"],
                                         self.pipe.cfg.vision.image_size)
            except (KeyError, TypeError, ValueError, OSError, SyntaxError) as e:
                # OSError: Pillow cannot identify or finish reading the image
                raise ValueError(f"invalid image_b64: {type(e).__name__}: {e}")
        if mode == "edit":
            # rasterized once here; the batch loop re-reads the array form
            payload["edit_region"] = self._edit_region(payload).tolist()
        self.q.put(req)
        return req

    def close(self):
        """Stop the threads, error-finalize every request they never took,
        and let in-flight assembly land."""
        self._stop.set()
        self._thread.join(timeout=60)
        self._prep_thread.join(timeout=10)
        leftovers: List[_Request] = []
        while True:
            try:
                batch, _prepared = self._ready.get_nowait()
            except queue.Empty:
                break
            leftovers.extend(batch)
        if self._held is not None:
            leftovers.append(self._held)
            self._held = None
        while True:
            try:
                leftovers.append(self.q.get_nowait())
            except queue.Empty:
                break
        if leftovers:
            for r in leftovers:
                r.error = "RuntimeError: server shutting down"
            self._finalize(leftovers)
        self._asm_pool.shutdown(wait=True)
        self._png_pool.shutdown(wait=False)

    # ------------------------------------------------------------- internals

    def _bucket(self, n: int, ps: int = 1) -> int:
        """The bucket of n requests of ps image rows each: min_batch and
        max_batch are device-row budgets, so both scale down by ps."""
        cap = max(1, self.max_batch // ps)
        floor = min(max(1, self.min_batch // ps), cap)
        for b in self.BUCKETS:
            if b >= max(n, floor):
                return min(b, cap)
        return cap

    @staticmethod
    def _req_seed(req: _Request) -> int:
        """The request's seed, or a fresh random 31-bit one (echoed)."""
        s = req.payload.get("seed")
        if s is None:
            return random.getrandbits(31)
        s = int(s)
        if not 0 <= s < 2 ** 32:
            raise ValueError(f"seed must be in [0, 2**32), got {s}")
        return s

    @staticmethod
    def _req_ps(req: _Request) -> int:
        ps = int(req.payload.get("parallel_size", 1))
        if not 1 <= ps <= 16:
            raise ValueError(f"parallel_size must be in [1, 16], got {ps}")
        return ps

    @staticmethod
    def _batch_key(req: _Request):
        """Requests batch together when they run the same shapes and prompt:
        the mode, parallel_size (it widens the device batch) and the mmu
        question (one prompt per batch). Seeds ride as per-row generators,
        so they do not split batches."""
        if req.mode in ("generate", "joint"):
            return (req.mode, Batcher._req_ps(req))
        if req.mode == "understand":
            return (req.mode, req.payload.get("question"))
        return (req.mode,)

    def _drain(self) -> List[_Request]:
        if self._held is not None:
            first, self._held = self._held, None
        else:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                return []
        batch = [first]
        cap = max(1, self.max_batch // self._req_ps(first))
        deadline = time.perf_counter() + self.wait_s
        while len(batch) < cap:
            now = time.perf_counter()
            if self._exec_busy.is_set() and self._ema_dev > 0.0:
                # the device is busy: keep collecting until just enough time
                # is left to build the batch before it frees
                est_free = self._exec_start + self._ema_dev - self._ema_prep - 0.05
                timeout = est_free - now
                if timeout <= 0:
                    break
                timeout = min(timeout, 0.1)  # re-check the device state
                final_wait = False
            else:
                timeout = deadline - now
                if timeout <= 0:
                    break
                final_wait = True
            try:
                nxt = self.q.get(timeout=timeout)
            except queue.Empty:
                if final_wait:
                    break
                continue
            if self._batch_key(nxt) != self._batch_key(first):
                # another program: hold it as the next batch's head
                self._held = nxt
                break
            batch.append(nxt)
        return batch

    def _prep_loop(self):
        """Drain and build batches on the host, one batch ahead of the device."""
        while not self._stop.is_set():
            if self._ready.full():
                time.sleep(0.02)
                continue
            batch = self._drain()
            if not batch:
                continue
            t0 = time.perf_counter()
            try:
                prepared = self._prepare(batch)
            except Exception as e:  # noqa: BLE001 — a bad batch fails its own waiters
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                self._finalize(batch)
                continue
            dt = time.perf_counter() - t0
            self._ema_prep = dt if self._ema_prep == 0.0 else 0.7 * self._ema_prep + 0.3 * dt
            with self._stats_lock:
                self.stats["prep_s"] = round(self.stats["prep_s"] + dt, 3)
            while not self._stop.is_set():
                try:
                    self._ready.put((batch, prepared), timeout=0.5)
                    break
                except queue.Full:
                    continue
            else:
                for r in batch:
                    r.error = "RuntimeError: server shutting down"
                self._finalize(batch)

    def _loop(self):
        """The device-owner thread."""
        while not self._stop.is_set():
            try:
                batch, prepared = self._ready.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            if self._last_run_end is not None:
                with self._stats_lock:
                    self.stats["idle_s"] = round(
                        self.stats["idle_s"] + t0 - self._last_run_end, 3)
            self._exec_start = t0
            self._exec_busy.set()
            try:
                deferred = self._execute(batch, prepared)
            except Exception as e:  # noqa: BLE001 — surface errors to every waiter
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                deferred = None
            finally:
                self._exec_busy.clear()
            self._last_run_end = time.perf_counter()
            dt = self._last_run_end - t0
            self._ema_dev = dt if self._ema_dev == 0.0 else 0.7 * self._ema_dev + 0.3 * dt
            with self._stats_lock:
                self.stats["device_s"] = round(self.stats["device_s"] + dt, 3)
            if deferred is not None:
                self._defer_sem.acquire()
                try:
                    self._asm_pool.submit(self._finish, batch, deferred)
                except RuntimeError:
                    # the pool is shut down (close() racing a final batch)
                    self._finish(batch, deferred)
            else:
                self._finalize(batch)

    def _finish(self, batch: List[_Request], deferred) -> None:
        t0 = time.perf_counter()
        try:
            deferred()
        except Exception as e:  # noqa: BLE001 — surface to every waiter
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
        finally:
            self._defer_sem.release()
        with self._stats_lock:
            self.stats["assembly_s"] = round(
                self.stats["assembly_s"] + time.perf_counter() - t0, 3)
        self._finalize(batch)

    def _finalize(self, batch: List[_Request]) -> None:
        # stats first: a client that has its answer sees its batch counted
        with self._stats_lock:
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
        for r in batch:
            r.done.set()

    @staticmethod
    def _pad(items: List[Any], bucket: int) -> List[Any]:
        return items + [items[0]] * (bucket - len(items))

    def _prepare(self, batch: List[_Request]) -> Dict[str, Any]:
        """The host half of a batch, on the prep thread: padding to the
        bucket and the pipeline's `host_*` batch builds (no CUDA call)."""
        mode = batch[0].mode
        n = len(batch)
        ps_rows = self._req_ps(batch[0]) if mode in ("generate", "joint") else 1
        bucket = self._bucket(n, ps=ps_rows)
        with self._stats_lock:
            self.stats["padded_rows"] += (bucket - n) * ps_rows

        if mode == "plan":
            caps = self._pad([r.payload["caption"] for r in batch], bucket)
            return {"plan": self.pipe.host_plan(caps)}

        if mode == "understand":
            imgs = self._pad([r.pixels for r in batch], bucket)
            return {"mmu": self.pipe.host_understand(
                np.stack(imgs), question=batch[0].payload.get("question"))}

        ps = self._req_ps(batch[0])  # one value per batch (the batch key)
        seeds = self._pad([self._req_seed(r) for r in batch], bucket)
        caps = self._pad([r.payload.get("caption", "") for r in batch], bucket)

        if mode == "joint":
            # stage 2's prompt needs the planned layout: built in _execute
            return {"plan": self.pipe.host_plan(caps), "caps": caps,
                    "seeds": seeds, "ps": ps, "bucket": bucket}

        if mode == "generate":
            groundings = self._pad([r.payload["grounding"] for r in batch], bucket)
            host = self.pipe.host_layout_to_image(caps, groundings, seeds=seeds,
                                                  parallel_size=ps)
            return {"gen": host, "groundings": groundings, "seeds": seeds,
                    "ps": ps, "bucket": bucket}

        if mode == "edit":
            groundings = self._pad([r.payload["grounding"] for r in batch], bucket)
            imgs = self._pad([r.pixels for r in batch], bucket)
            regions = self._pad([self._edit_region(r.payload) for r in batch], bucket)
            negs = [r.payload.get("neg_grounding") for r in batch]
            neg_groundings = self._pad([g or "" for g in negs], bucket) if any(negs) else None
            host = self.pipe.host_layout_to_image(
                caps, groundings, neg_groundings=neg_groundings,
                gt_images=np.stack(imgs), edit_region=np.stack(regions),
                seeds=seeds,
                # one edited image per request, whatever the config's
                # parallel_size: the bucket math counts one row a request
                parallel_size=1, teacher_forcing=True,
            )
            return {"gen": host, "seeds": seeds}

        raise ValueError(f"unknown mode {mode!r}")

    def _execute(self, batch: List[_Request], prepared: Dict[str, Any]):
        """The device half, on the device-owner thread: the `embed_*`
        halves, the decode, the VQ decode. Returns None (results written)
        or the batch's deferred assembly."""
        mode = batch[0].mode
        pipe = self.pipe

        if mode == "plan":
            outs = pipe.plan_from_prepared(pipe.embed_plan(prepared["plan"]))
            for r, g in zip(batch, outs):
                r.result = {"grounding": g}
            return None

        if mode == "understand":
            out = pipe.understand_from_prepared(pipe.embed_understand(prepared["mmu"]))
            for r, g in zip(batch, out.groundings):
                r.result = {"grounding": g}
            return None

        if mode in ("generate", "joint"):
            ps, seeds, bucket = prepared["ps"], prepared["seeds"], prepared["bucket"]
            if mode == "joint":
                groundings = pipe.plan_from_prepared(pipe.embed_plan(prepared["plan"]))
                out = pipe.layout_to_image(prepared["caps"], groundings, seeds=seeds,
                                           parallel_size=ps)
            else:
                groundings = prepared["groundings"]
                out = pipe.execute_image_gen(pipe.embed_layout_to_image(prepared["gen"]))

            def assemble_generate(batch=batch, out=out, groundings=groundings,
                                  seeds=seeds, ps=ps, bucket=bucket):
                # the pixels' fetch (waited on here) and the PNG encoding
                # overlap the next batch's device work
                images = np.asarray(out.images)
                # parallel_size rows are copy-major: request i's sample c
                # sits at row c * bucket + i
                all_rows = sorted({c * bucket + i for i in range(len(batch))
                                   for c in range(ps)})
                encoded = dict(zip(all_rows, self._png_pool.map(
                    _png_b64, [images[j] for j in all_rows])))
                for i, r in enumerate(batch):
                    rows = [c * bucket + i for c in range(ps)]
                    r.result = {
                        "image_b64": encoded[rows[0]],
                        "images_b64": [encoded[j] for j in rows],
                        "grounding": groundings[i],
                        "tokens": [int(t) for t in out.image_tokens[rows[0]]],
                        "seed": seeds[i],
                    }

            return assemble_generate

        if mode == "edit":
            seeds = prepared["seeds"]
            out = pipe.execute_image_gen(pipe.embed_layout_to_image(prepared["gen"]))

            def assemble_edit(batch=batch, out=out, seeds=seeds):
                images = np.asarray(out.images)
                pngs = list(self._png_pool.map(
                    _png_b64, [images[i] for i in range(len(batch))]))
                for i, r in enumerate(batch):
                    r.result = {
                        "image_b64": pngs[i],
                        "tokens": [int(t) for t in out.image_tokens[i]],
                        "seed": seeds[i],
                    }

            return assemble_edit

        raise ValueError(f"unknown mode {mode!r}")


def make_handler(batcher: Batcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                with batcher._stats_lock:
                    stats = dict(batcher.stats)
                self._send(200, {"ok": True, "stats": stats})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            mode = self.path.strip("/")
            if mode not in MODES:
                self._send(404, {"error": f"unknown endpoint {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                self._send(400, {"error": f"bad json: {e}"})
                return
            try:
                req = batcher.submit(mode, payload)
            except (ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            req.done.wait()
            if req.error:
                self._send(500, {"error": req.error})
            else:
                self._send(200, req.result)

    return Handler


def make_server(batcher: Batcher, host: str = "127.0.0.1", port: int = 8000
                ) -> ThreadingHTTPServer:
    """The HTTP server in front of `batcher` (port 0: any free port). Its
    listen backlog holds a burst of max_batch concurrent connections."""

    class _Server(ThreadingHTTPServer):
        request_queue_size = max(128, 4 * batcher.max_batch)

    return _Server((host, port), make_handler(batcher))


def _warmup_payloads(mode: str, n: int, n_img: int) -> List[Dict[str, Any]]:
    """n synthetic payloads for one warmup batch of `mode`."""
    g = "<grounding><ref>warmup</ref><box>[100, 100, 500, 500]</box></grounding>"
    if mode == "generate":
        base: Dict[str, Any] = {"caption": "warmup", "grounding": g}
    elif mode in ("plan", "joint"):
        base = {"caption": "warmup"}
    elif mode == "understand":
        base = {"image_b64": _png_b64(np.zeros((32, 32, 3), dtype=np.uint8))}
    elif mode == "edit":
        base = {"caption": "warmup", "grounding": g,
                "image_b64": _png_b64(np.zeros((32, 32, 3), dtype=np.uint8)),
                "edit_region": [1] * (n_img // 2) + [0] * (n_img - n_img // 2)}
    else:
        raise ValueError(f"unknown warmup mode {mode!r}")
    return [{**base, "seed": i} for i in range(n)]


def warmup(batcher: Batcher, spec: str, timeout: float = 3600.0) -> None:
    """Drive the real request path with synthetic batches before the server
    takes traffic: kernels built, cuBLAS workspaces made, the first graph
    captured. `spec` is "mode:batch,mode:batch,..." (e.g.
    "generate:32,plan:8"); each group is submitted as one burst so it forms
    one batch of its bucket."""
    n_img = batcher.pipe.cfg.image_seq_len
    for item in spec.split(","):
        mode, _, b = item.strip().partition(":")
        n = int(b) if b else batcher.max_batch
        t0 = time.perf_counter()
        reqs = [batcher.submit(mode, p) for p in _warmup_payloads(mode, n, n_img)]
        for r in reqs:
            if not r.done.wait(timeout=timeout):
                raise TimeoutError(f"warmup {mode}:{n} exceeded {timeout}s")
            if r.error:
                raise RuntimeError(f"warmup {mode}:{n} failed: {r.error}")
        print(f"warmup {mode}:{n} done in {time.perf_counter() - t0:.1f}s", flush=True)


def serve(cfg, host: str = "127.0.0.1", port: int = 8000, max_batch: int = 32,
          wait_ms: float = 20.0, model=None, min_batch: int = 1,
          warmup_spec: Optional[str] = None, device=None):
    """Build the pipeline (on the card unless `device` names another) and
    serve until interrupted. Pixels leave the card as uint8
    (`output_uint8`), their fetch deferred to the assembler."""
    import dataclasses

    from plangen_tpu_torch.tasks.eval import build_pipeline

    if not cfg.generation.output_uint8:
        cfg = dataclasses.replace(
            cfg, generation=dataclasses.replace(cfg.generation, output_uint8=True))
    pipe = build_pipeline(cfg, model=model, device=device)
    pipe.defer_fetch = True
    batcher = Batcher(pipe, max_batch=max_batch, wait_ms=wait_ms, min_batch=min_batch)
    try:
        if warmup_spec:
            warmup(batcher, warmup_spec)
        httpd = make_server(batcher, host, port)
        print(f"serving on http://{host}:{httpd.server_address[1]} "
              f"(max_batch={max_batch}, min_batch={min_batch}, wait_ms={wait_ms})",
              flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    finally:
        batcher.close()
    return httpd
