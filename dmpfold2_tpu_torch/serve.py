"""HTTP folding service.

Counterpart of ``dmpfold2_tpu/serve.py``: a threaded HTTP server for
deployment behind a load balancer, on one GPU or, with ``--mesh``, data-
parallel over several GPUs of one machine (each coalesced batch split over
them). Concurrent requests are coalesced by a dispatcher thread and folded
together per shape bucket through the batch engine
(``parallel/stream.BatchFolder``); under low load a lone request is a batch
of one, on the same path. Endpoints:

  POST /fold?iterations=10&minsteps=100   body: aln (or a3m) text -> PDB text
  POST /fold   (Content-Type: application/json)
       body: {"aln": "...", "template_pdb": "ATOM...", "iterations": 10,
              "minsteps": 100} -> PDB text; the JSON form carries an
       optional template PDB (the CLI's ``-t``)
  GET  /healthz                           liveness (cached; folds at most once)
  GET  /stats                             throughput + batching counters (JSON)

Request hardening: bodies above ``--max-body-mb`` are rejected with 413
without reading them, a missing or invalid Content-Length is a 411/400, and a
client that stalls mid-body trips the socket read timeout (408) instead of
holding a handler thread.

Run: ``python -m dmpfold2_tpu_torch.serve --port 8080 --weights params.npz
[-d cpu] [--mesh DATA[xSEQ]|auto]``. The device defaults to ``cuda``;
without it the service raises.
"""

from __future__ import annotations

import argparse
import json
import queue
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .engine.fold import DEFAULT_ITERATIONS, DEFAULT_MINSTEPS
from .parallel.stream import BatchFolder, Target
from .utils import aln as aln_io
from .utils import pdb as pdb_io
from .utils import obs
from .utils.obs import Counters

# the tiny alignment folded by the first /healthz probe of a service that
# was not warmed up
HEALTH_ALN = "ARNDARNDARNDARND\n"
HEALTH_SHAPE = (1, 16)


@dataclass
class _FoldRequest:
    alnmat: np.ndarray
    iterations: int
    minsteps: int
    template_ca: np.ndarray | None = None
    event: threading.Event = field(default_factory=threading.Event)
    result: tuple | None = None
    error: Exception | None = None


class FoldService:
    """Folding backend shared by request handlers.

    Handler threads enqueue requests; a dispatcher thread coalesces what
    arrives within ``batch_window_s`` (up to ``max_batch``), groups it by
    (iterations, minsteps) and hands each group to ``BatchFolder``, so N
    concurrent requests of one bucket cost one batch, not N folds. A finisher
    thread waits for each group's results; at most two groups are in flight.
    The parameters are uploaded once per device, by the batch engine's held
    ``Folder``s. Every request rides the batched path: a lone request is a
    batch of one (the single fold is the batched forward at B 1) run on a
    worker thread, so the dispatcher never waits for a fold. With a ``mesh``
    (one process; ``parallel.mesh.make_mesh``) each batch splits over the
    mesh's devices.
    """

    def __init__(self, params, precision: str = "bf16", device=None,
                 batch_window_s: float = 0.05, max_batch: int = 8,
                 max_body_bytes: int = 64 * 2 ** 20, read_timeout_s: float = 30.0,
                 busy_collect_cap_s: float = 30.0, mesh=None):
        self.max_body_bytes = max_body_bytes
        self.read_timeout_s = read_timeout_s
        self.counters = Counters()
        self.batcher = BatchFolder(params, device=device, precision=precision,
                                   counters=self.counters, mesh=mesh)
        self.folder = self.batcher.folder
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        # cap on busy-coalescing, so one long fold in flight cannot hold a
        # queued request for ever
        self.busy_collect_cap_s = busy_collect_cap_s
        self.batch_stats = {"dispatches": 0, "requests": 0, "max_coalesced": 0}
        self._ready = threading.Event()
        self._closed = False
        self._queue: queue.Queue = queue.Queue()
        # the dispatcher pads and hands each group to the batch engine's
        # workers and queues a finisher here; the finisher thread waits for
        # the results. maxsize bounds the groups in flight (and their inputs
        # on the device).
        self._finish_queue: queue.Queue = queue.Queue(maxsize=2)
        # groups in flight (queued + finishing): while > 0 the dispatcher
        # keeps coalescing instead of launching undersized batches
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()
        self._finish_thread = threading.Thread(target=self._finish_loop, daemon=True)
        self._finish_thread.start()

    # -- lifecycle ---------------------------------------------------------

    def _batch_ladder(self) -> list[int]:
        """Batch sizes a group is padded to: powers of two from 1 to max_batch."""
        sizes = [1]
        while sizes[-1] < self.max_batch:
            sizes.append(min(sizes[-1] * 2, self.max_batch))
        return sizes

    def _quantized_batch(self, n: int) -> int:
        """Smallest ladder size >= n (capped at max_batch)."""
        for bs in self._batch_ladder():
            if bs >= n:
                return bs
        return self.max_batch

    def warmup(self, shapes=((256, 96), (256, 128))) -> None:
        """Fold each shape and the healthz shape once on every device's held
        ``Folder`` (building the kernels on a GPU), then each shape at every
        ladder batch size through the batch engine, which every request
        rides; marks the service ready, so /healthz answers from cache."""
        shapes = tuple(shapes)
        for folder in self.batcher.folders:
            folder.warmup(shapes=shapes + (HEALTH_SHAPE,))
        for nseqs, nres in shapes:
            aln = np.zeros((nseqs, nres), np.uint8)
            for bs in self._batch_ladder():
                self.batcher.batch_size = bs
                self.batcher.fold_many([Target(alnmat=aln)] * 2, iterations=1, minsteps=1)
        self.counters.reset()  # /stats counts served targets from the first dispatch on
        self._ready.set()

    def ready(self) -> bool:
        return self._ready.is_set()

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)

    def _busy(self) -> bool:
        with self._inflight_lock:
            return self._inflight > 0

    # -- request path ------------------------------------------------------

    def fold_aln_text(self, text: str, iterations: int, minsteps: int,
                      template_ca: np.ndarray | None = None) -> str:
        # aln or a3m bodies (lowercase insertion states stripped)
        alnmat = aln_io.encode_rows(aln_io.a3m_to_rows(text))[: aln_io.MAX_SEQS]
        if template_ca is not None and template_ca.shape[0] != alnmat.shape[1]:
            # a client error (400), checked before the request is queued
            raise ValueError(
                f"template has {template_ca.shape[0]} CA atoms but alignment "
                f"has {alnmat.shape[1]} residues — lengths must match")
        if self._closed:
            raise RuntimeError("service is shutting down")
        req = _FoldRequest(alnmat, iterations, minsteps, template_ca)
        self._queue.put(req)
        while not req.event.wait(timeout=1.0):
            # the close() race: if the pipeline exited after the check above
            # but before the put, nobody will set the event
            if self._closed and not (self._thread.is_alive()
                                     or self._finish_thread.is_alive()):
                raise RuntimeError("service is shutting down")
        if req.error is not None:
            raise req.error
        coords, confs = req.result
        self._ready.set()
        return "\n".join(pdb_io.format_pdb(coords, confs, alnmat[0])) + "\n"

    # -- dispatcher --------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                self._drain_closed()
                # the finisher retires every group already launched, then exits
                self._finish_queue.put(None)
                return
            batch = [req]
            # coalescing: a lone request on an idle service goes at once;
            # when more is queued, collect within batch_window_s; while a
            # group is in flight, collect until it drains (or the cap), since
            # a batch launched early would only queue behind it on the device
            opened = not self._queue.empty()
            deadline = time.monotonic() + self.batch_window_s
            busy_cap = time.monotonic() + self.busy_collect_cap_s
            # while busy, dispatch at half the max batch: with two groups in
            # flight, a closed-loop client pool splits into two half batches
            busy_target = max(1, self.max_batch // 2)
            while len(batch) < self.max_batch:
                now = time.monotonic()
                busy = now < busy_cap and self._busy()
                if busy and len(batch) >= busy_target:
                    break
                if busy:
                    timeout = 0.01  # poll: wake soon after the device drains
                elif opened and now < deadline:
                    timeout = deadline - now
                else:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    if busy:
                        continue  # still busy: hold out for a fuller batch
                    break
                if nxt is None:  # shutdown mid-coalesce: finish this batch first
                    self._queue.put(None)
                    break
                batch.append(nxt)

            groups: dict[tuple[int, int], list[_FoldRequest]] = {}
            for r in batch:
                groups.setdefault((r.iterations, r.minsteps), []).append(r)
            for (it, ms), reqs in groups.items():
                fin = self._launch_group(it, ms, reqs)
                if fin is not None:
                    with self._inflight_lock:
                        self._inflight += 1
                    self._finish_queue.put(fin)  # blocks while 2 groups are in flight

    def _drain_closed(self) -> None:
        """Fail any request queued in the close() race, so its handler thread
        does not wait for ever."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.error = RuntimeError("service is shutting down")
                req.event.set()

    def _finish_loop(self) -> None:
        while True:
            fin = self._finish_queue.get()
            if fin is None:
                return
            try:
                fin()
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def _launch_group(self, iterations: int, minsteps: int, reqs: list[_FoldRequest]):
        """Launch one (iterations, minsteps) group without waiting for its
        results. Returns the finisher (run on the finisher thread) that
        fetches and hands out the results, or None when the launch itself
        failed (the requests' events are then set)."""
        self.batch_stats["dispatches"] += 1
        self.batch_stats["requests"] += len(reqs)
        self.batch_stats["max_coalesced"] = max(self.batch_stats["max_coalesced"], len(reqs))

        # pad the batch to a ladder size, so mid-size groups do not pad all
        # the way to max_batch and the set of batch shapes stays small
        self.batcher.batch_size = self._quantized_batch(len(reqs))
        try:
            pending = self.batcher.fold_many_async(
                [Target(alnmat=r.alnmat, template_ca=r.template_ca) for r in reqs],
                iterations=iterations, minsteps=minsteps)
        except Exception as exc:  # noqa: BLE001 - reported to the requests
            for r in reqs:
                r.error = exc
                r.event.set()
            return None

        def finish_batched():
            try:
                results = pending.wait()
            except Exception as exc:  # noqa: BLE001 - reported to the requests
                for r in reqs:
                    r.error = exc
                    r.event.set()
                return
            for r, res in zip(reqs, results):
                if res is None:
                    r.error = RuntimeError("fold failed (see target_error log)")
                else:
                    r.result = res
                r.event.set()

        return finish_batched


def make_handler(service: FoldService):
    class Handler(BaseHTTPRequestHandler):
        # socket timeout for every read on this connection: a client that
        # stalls mid-body cannot hold a handler thread
        timeout = service.read_timeout_s

        def log_message(self, fmt, *args):  # quiet default access log
            pass

        def _send(self, code: int, body: str, ctype: str = "text/plain"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                # after warmup (or any successful fold) the probe costs
                # nothing; only the first probe of a cold service folds
                if service.ready():
                    self._send(200, "ok\n")
                    return
                try:
                    service.fold_aln_text(HEALTH_ALN, 0, 0)
                except Exception as exc:  # noqa: BLE001 - reported as unhealthy
                    self._send(500, f"unhealthy: {exc}\n")
                    return
                self._send(200, "ok\n")
            elif path == "/stats":
                stats = service.counters.summary()
                stats["batching"] = dict(service.batch_stats)
                self._send(200, json.dumps(stats) + "\n", "application/json")
            else:
                self._send(404, "not found\n")

        def _read_body(self) -> bytes | None:
            """Bounded, timeout-guarded body read; sends the error response
            and returns None on failure."""
            raw_len = self.headers.get("Content-Length")
            if raw_len is None:
                self._send(411, "length required\n")
                return None
            try:
                length = int(raw_len)
            except ValueError:
                self._send(400, f"bad Content-Length: {raw_len!r}\n")
                return None
            if length < 0:
                self._send(400, "bad Content-Length: negative\n")
                return None
            if length > service.max_body_bytes:
                # rejected before reading: a large Content-Length must not
                # make the server buffer the body
                self._send(413, f"body too large ({length} bytes > "
                                f"{service.max_body_bytes} limit)\n")
                return None
            try:
                body = self.rfile.read(length)
            except TimeoutError:  # the client stalled mid-body
                self._send(408, "request body read timed out\n")
                return None
            if len(body) < length:  # the client closed early
                self._send(400, "truncated body\n")
                return None
            return body

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/fold":
                self._send(404, "not found\n")
                return
            body = self._read_body()
            if body is None:
                return
            query = parse_qs(parsed.query)
            template_ca = None
            try:
                iterations = int(query.get("iterations", [DEFAULT_ITERATIONS])[0])
                minsteps = int(query.get("minsteps", [DEFAULT_MINSTEPS])[0])
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
                if ctype == "application/json":
                    # the alignment, an optional template PDB, and
                    # iterations/minsteps overridable in the body
                    doc = json.loads(body.decode())
                    if not isinstance(doc, dict) or "aln" not in doc:
                        raise ValueError('JSON body must be {"aln": ...}')
                    text = str(doc["aln"])
                    iterations = int(doc.get("iterations", iterations))
                    minsteps = int(doc.get("minsteps", minsteps))
                    if doc.get("template_pdb"):
                        template_ca = pdb_io.parse_template_ca_text(str(doc["template_pdb"]))
                else:
                    text = body.decode()
            except (ValueError, UnicodeDecodeError) as exc:
                self._send(400, f"bad request: {exc}\n")
                return
            try:
                pdb_text = service.fold_aln_text(text, iterations, minsteps, template_ca)
            except ValueError as exc:  # a malformed alignment: the client's error
                self._send(400, f"bad alignment: {exc}\n")
                return
            except Exception as exc:  # noqa: BLE001 - device faults: the server's error
                self._send(500, f"internal error: {exc}\n")
                return
            self._send(200, pdb_text, "chemical/x-pdb")

    return Handler


def serve(params, host: str = "0.0.0.0", port: int = 8080, precision: str = "bf16",
          device=None, batch_window_s: float = 0.05, max_batch: int = 8,
          max_body_bytes: int = 64 * 2 ** 20, read_timeout_s: float = 30.0,
          busy_collect_cap_s: float = 30.0, mesh=None) -> ThreadingHTTPServer:
    service = FoldService(params, precision, device, batch_window_s=batch_window_s,
                          max_batch=max_batch, max_body_bytes=max_body_bytes,
                          read_timeout_s=read_timeout_s,
                          busy_collect_cap_s=busy_collect_cap_s, mesh=mesh)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.fold_service = service  # for warmup and introspection
    return server


def main(argv=None):
    from .engine.fold import load_weights

    ap = argparse.ArgumentParser(description="DMPfold2 folding service (PyTorch/CUDA)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--weights", default=None, help="model weights (.npz or .pt state dict)")
    ap.add_argument("-d", "--device", default=None,
                    help="torch device to run on: cuda (default) or cpu")
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16", "fp32_strict"])
    ap.add_argument("--batch-window-ms", type=float, default=50.0,
                    help="request-coalescing window for batched dispatch")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-body-mb", type=float, default=64.0,
                    help="reject request bodies above this size (413)")
    ap.add_argument("--read-timeout-s", type=float, default=30.0,
                    help="socket read timeout per request (408 on stall)")
    ap.add_argument("--busy-collect-cap-s", type=float, default=30.0,
                    help="longest a request waits for a fuller batch while one is in flight")
    ap.add_argument("--warmup", default="256x96,256x128", metavar="NxL,...",
                    help="comma-separated (nseqs x nres) shapes to fold before accepting "
                         "traffic: the deployment's expected bucket mix")
    ap.add_argument("--mesh", default=None, metavar="DATA[xSEQ]|auto",
                    help="serve data-parallel over a mesh of this machine's GPUs, e.g. '2'; "
                         "DATAxSEQ splits each fold's pair trunk by rows over SEQ GPUs; "
                         "'auto' = every visible GPU (with -d cpu: CPU replicas)")
    args = ap.parse_args(argv)
    obs.trace_from_env()  # DMPFOLD2_TPU_TRACE=<path>: spans to a Chrome trace at exit
    mesh = device = None
    if args.mesh is not None:
        from .parallel.mesh import parse_mesh

        mesh = parse_mesh(args.mesh, args.device)
    else:
        device = args.device
    warmup_shapes = tuple(tuple(int(v) for v in s.split("x"))
                          for s in args.warmup.split(",") if s)
    server = serve(load_weights(args.weights), args.host, args.port, args.precision,
                   device, batch_window_s=args.batch_window_ms / 1000.0,
                   max_batch=args.max_batch, max_body_bytes=int(args.max_body_mb * 2 ** 20),
                   read_timeout_s=args.read_timeout_s,
                   busy_collect_cap_s=args.busy_collect_cap_s, mesh=mesh)

    # graceful drain on SIGTERM/SIGINT (load balancers send SIGTERM on
    # rollouts): stop taking work, fail queued requests fast, let the groups
    # in flight finish, then return from serve_forever
    def _graceful(signum, frame):
        print("shutting down (draining in-flight folds)...", file=sys.stderr)
        server.fold_service.close()
        # shutdown() blocks until serve_forever exits: not on this frame
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    print("warming up (building the kernels and folding the warm-up shapes)...", flush=True)
    server.fold_service.warmup(shapes=warmup_shapes)
    print(f"serving on {args.host}:{server.server_address[1]}", flush=True)
    server.serve_forever()
    server.server_close()
    server.fold_service.batcher.close()


if __name__ == "__main__":
    main()
