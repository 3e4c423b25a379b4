"""The PyTorch port's HTTP folding service (``dmpfold2_tpu_torch/serve.py``)
on an in-process CPU server with a toy model: the behaviours of
tests/test_serve.py (the mesh-sharded service is in
tests/test_torch_multiprocess.py)."""

import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from dmpfold2_tpu.models.gruresnet import init_params as jax_init_params
from dmpfold2_tpu.weights import save_params
from dmpfold2_tpu_torch import serve as serve_mod
from dmpfold2_tpu_torch.serve import serve
from dmpfold2_tpu_torch.utils.pdb import format_pdb
from dmpfold2_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALN = ">q\nIKLTVGGVDITFEPN\nITLTIAGTDISFEPT\n"


def _tree(width=32, cwidth=16):
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), width=width,
                                                    cwidth=cwidth, num_blocks=2))


def _start(**kw):
    server = serve(params_from_jax(_tree()), host="127.0.0.1", port=0, precision="fp32",
                   device="cpu", **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server):
    server.shutdown()
    server.fold_service.close()
    server.server_close()


@pytest.fixture(scope="module")
def server_url():
    server, url = _start()
    yield url
    _stop(server)


def _post(url, data: bytes, headers=None, timeout=300):
    req = urllib.request.Request(url, data=data, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _post_error(url, data: bytes, headers=None) -> urllib.error.HTTPError:
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, data, headers)
    return err.value


def test_healthz(server_url):
    with urllib.request.urlopen(f"{server_url}/healthz", timeout=300) as resp:
        assert resp.status == 200


def test_fold_roundtrip(server_url):
    status, body = _post(f"{server_url}/fold?iterations=1&minsteps=2",
                         b">query\nIKLTVGGVDITFEPN\nITLTIAGTDISFEPT\nIVLGVAGTDLTFKPT\n")
    assert status == 200
    assert body.startswith("REMARK  CONF:")
    assert "ATOM" in body and body.rstrip().endswith("END")
    with urllib.request.urlopen(f"{server_url}/stats", timeout=30) as resp:
        stats = json.loads(resp.read())
    assert stats["targets"] >= 1 and "batching" in stats


def test_fold_bad_input(server_url):
    assert _post_error(f"{server_url}/fold", b"").code == 400


def test_fold_bad_params_is_400(server_url):
    assert _post_error(f"{server_url}/fold?iterations=ten", b"ARND\n").code == 400


def test_fold_a3m_body(server_url):
    status, _ = _post(f"{server_url}/fold?iterations=0&minsteps=0",
                      b">q\nARNDARND\n>s\nAbRNDARcND\n")  # a3m insertions stripped
    assert status == 200


def _template_pdb_text(nres: int, seed: int = 3) -> str:
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(nres, 5, 3)).astype(np.float32) * 3
    return "\n".join(format_pdb(coords, np.full((nres,), 0.5, np.float32),
                                np.zeros((nres,), np.int64)))


def _post_json(url, doc):
    return _post(f"{url}/fold", json.dumps(doc).encode(),
                 {"Content-Type": "application/json"})


def test_fold_json_template_roundtrip(server_url):
    doc = {"aln": "IKLTVGGVDITFEPN\nITLTIAGTDISFEPT\n", "template_pdb": _template_pdb_text(15),
           "iterations": 1, "minsteps": 2}
    status, body = _post_json(server_url, doc)
    assert status == 200 and body.startswith("REMARK  CONF:") and body.rstrip().endswith("END")


def test_fold_json_template_affects_result(server_url):
    aln = "IKLTVGGVDITFEPN\nITLTIAGTDISFEPT\n"
    plain = _post_json(server_url, {"aln": aln, "iterations": 0, "minsteps": 0})[1]
    tmpl = _post_json(server_url, {"aln": aln, "template_pdb": _template_pdb_text(15),
                                   "iterations": 0, "minsteps": 0})[1]
    assert plain != tmpl


def test_fold_json_template_length_mismatch_400(server_url):
    doc = {"aln": "ARNDARND\n", "template_pdb": _template_pdb_text(5)}
    err = _post_error(f"{server_url}/fold", json.dumps(doc).encode(),
                      {"Content-Type": "application/json"})
    assert err.code == 400 and "lengths must match" in err.read().decode()


@pytest.fixture(scope="module")
def hardened():
    """A server with a tiny body cap and a short read timeout."""
    server, url = _start(max_body_bytes=1000, read_timeout_s=0.5)
    yield url, server.server_address[1]
    _stop(server)


def test_oversized_body_rejected_413(hardened):
    assert _post_error(f"{hardened[0]}/fold", b"A" * 2000).code == 413


def _raw_post(port, shut_write: bool) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(b"POST /fold HTTP/1.1\r\nHost: x\r\nContent-Length: 100\r\n\r\npartial")
        if shut_write:
            sock.shutdown(socket.SHUT_WR)
        sock.settimeout(10)
        return sock.recv(4096).split(b"\r\n", 1)[0]


def test_slow_client_times_out_408(hardened):
    assert b"408" in _raw_post(hardened[1], shut_write=False)


def test_truncated_body_400(hardened):
    assert b"400" in _raw_post(hardened[1], shut_write=True)


def _clients(url, n, query="iterations=0&minsteps=1"):
    bodies, errors = [], []

    def client():
        try:
            bodies.append(_post(f"{url}/fold?{query}", ALN.encode())[1])
        except Exception as exc:  # noqa: BLE001 - surfaced in the caller's assert
            errors.append(exc)

    threads = [threading.Thread(target=client) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return bodies, errors


def test_concurrent_requests_are_batched():
    """Concurrent requests of one configuration coalesce into fewer batches
    than requests, at least one of them with several targets."""
    server, url = _start(batch_window_s=1.0, max_batch=8)
    service = server.fold_service
    try:
        bodies, errors = _clients(url, 4)
    finally:
        _stop(server)
    assert not errors, errors
    assert len(bodies) == 4 and all(b.startswith("REMARK  CONF:") for b in bodies)
    assert service.batch_stats["requests"] == 4
    assert service.batch_stats["max_coalesced"] >= 2
    assert service.batch_stats["dispatches"] < 4


def test_busy_collect_cap_is_a_constructor_argument():
    """While a group is in flight, a lone request waits for batchmates up to
    ``busy_collect_cap_s``, then goes alone."""
    server, url = _start(batch_window_s=0.0, busy_collect_cap_s=0.3)
    service = server.fold_service
    assert service.busy_collect_cap_s == 0.3
    with service._inflight_lock:
        service._inflight += 1  # a group in flight
    try:
        t0 = time.monotonic()
        bodies, errors = _clients(url, 1, "iterations=0&minsteps=0")
        held = time.monotonic() - t0
    finally:
        with service._inflight_lock:
            service._inflight -= 1
        _stop(server)
    assert not errors and len(bodies) == 1
    assert 0.3 <= held < 60
    assert service.batch_stats["dispatches"] == 1


def test_lone_request_is_a_batch_of_one(monkeypatch):
    """A lone request goes through the batch engine at batch size 1 (the
    ladder starts at 1), not through a fold on the dispatcher thread."""
    server, url = _start(batch_window_s=0.0, max_batch=8)
    service = server.fold_service
    assert service._batch_ladder() == [1, 2, 4, 8]
    sizes = []
    fold_many_async = service.batcher.fold_many_async

    def recording(targets, *args, **kw):
        sizes.append((len(targets), service.batcher.batch_size))
        return fold_many_async(targets, *args, **kw)

    def no_single_fold(*args, **kw):
        raise AssertionError("a lone request folded outside the batch engine")

    monkeypatch.setattr(service.batcher, "fold_many_async", recording)
    monkeypatch.setattr(service.folder, "fold_async", no_single_fold)
    try:
        bodies, errors = _clients(url, 1, "iterations=0&minsteps=0")
    finally:
        _stop(server)
    assert not errors, errors
    assert len(bodies) == 1 and bodies[0].startswith("REMARK  CONF:")
    assert sizes == [(1, 1)]
    assert service.batch_stats == {"dispatches": 1, "requests": 1, "max_coalesced": 1}


class _Built(Exception):
    """Raised in place of building the server: carries serve()'s arguments."""


def _capture_serve(monkeypatch):
    """``serve_mod.main`` up to the server: weights a stub, ``serve`` raising
    :class:`_Built` with its arguments."""
    from dmpfold2_tpu_torch.engine import fold as fold_mod

    def fake_serve(*args, **kw):
        raise _Built(args, kw)

    monkeypatch.setattr(fold_mod, "load_weights", lambda path=None: {})
    monkeypatch.setattr(serve_mod, "serve", fake_serve)


def test_mesh_is_refused(monkeypatch):
    """A mesh with an empty residue (seq) axis is refused before the server
    is built."""
    _capture_serve(monkeypatch)
    with pytest.raises(ValueError, match="seq axis"):
        serve_mod.main(["--mesh", "2x0", "-d", "cpu"])


def test_mesh_data_x_seq_reaches_serve(monkeypatch):
    """``--mesh 4x2 -d cpu`` hands ``serve`` a 4 x 2 grid of CPU shards."""
    _capture_serve(monkeypatch)
    with pytest.raises(_Built) as built:
        serve_mod.main(["--mesh", "4x2", "-d", "cpu"])
    mesh = built.value.args[1]["mesh"]
    assert mesh.shape == {"data": 4, "seq": 2} and mesh.n_local == 4


def test_sigterm_graceful_shutdown(tmp_path):
    """``python -m dmpfold2_tpu_torch.serve`` drains and exits 0 on SIGTERM."""
    wpath = str(tmp_path / "tiny.npz")
    save_params(wpath, _tree(width=16, cwidth=8))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmpfold2_tpu_torch.serve", "--host", "127.0.0.1", "--port",
         "0", "--weights", wpath, "--precision", "fp32", "--warmup", "8x16", "-d", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        deadline = time.time() + 300
        line = ""
        while time.time() < deadline:
            if not select.select([proc.stdout], [], [], 5.0)[0]:
                continue
            line = proc.stdout.readline()
            if "serving on" in line or not line:
                break
        assert "serving on" in line, f"server never came up: {line!r}"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
