"""The port's threshold-encoded gradient sharing (``parallel.grad_sharing``
and the socket transport of ``parallel.transport``) on the CPU: the tests
of ``tests/test_grad_transport.py`` and the port held against the JAX
package — ``AdaptiveThreshold`` and ``GradientSharingAccumulator.step``
are equal on the same inputs, the gradient frames are the same bytes, and
a port worker and a JAX worker share one hub. The two-process
convergence run stays slow, as the reference marks it. Every blocking
wait is bounded.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.parallel import grad_sharing as jgs
from deeplearning4j_tpu.parallel import transport as jtransport
from deeplearning4j_tpu_torch.parallel import transport
from deeplearning4j_tpu_torch.parallel.grad_sharing import (
    AdaptiveThreshold, GradientSharingAccumulator)
from deeplearning4j_tpu_torch.parallel.transport import (
    DistributedGradientWorker, GradientExchangeServer,
    SocketGradientTransport)

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 30


def _run_threads(fns):
    errs = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:      # noqa: BLE001 — asserted below
            errs.append(e)
    ts = [threading.Thread(target=wrap, args=(f,), daemon=True) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in ts), "worker thread hung"
    assert errs == []


def test_socket_transport_unix_and_tcp_roundtrip(tmp_path):
    """Both socket families: 2 worker threads exchange through the hub;
    decoded sums match the accumulator's."""
    for address in [("127.0.0.1", 0), str(tmp_path / "grad.sock")]:
        server = GradientExchangeServer(n_workers=2, address=address).start()
        grads = [np.full(32, 0.01, np.float32),
                 np.full(32, -0.01, np.float32)]
        results = [None, None]

        def run(wid):
            t = SocketGradientTransport(server.address, timeout=WAIT_S)
            w = DistributedGradientWorker(32, t, threshold=1e-3,
                                          adaptive=False)
            results[wid] = w.step(grads[wid])
            t.close()

        try:
            _run_threads([lambda: run(0), lambda: run(1)])
        finally:
            server.stop()
        np.testing.assert_allclose(results[0], np.zeros(32), atol=1e-7)
        np.testing.assert_array_equal(results[0], results[1])


def test_server_stop_before_workers_connect_does_not_hang():
    server = GradientExchangeServer(n_workers=2).start()
    server.stop()
    assert not server._thread.is_alive()


def test_adaptive_threshold_matches_reference():
    rng = np.random.default_rng(0)
    ours, ref = AdaptiveThreshold(1e-3, 0.1, 1.5, max_threshold=10.0), \
        jgs.AdaptiveThreshold(1e-3, 0.1, 1.5, max_threshold=10.0)
    for _ in range(200):
        enc, tot = int(rng.integers(0, 1000)), int(rng.integers(1, 1000))
        assert ours.update(enc, tot) == ref.update(enc, tot)


@pytest.mark.parametrize("adaptive", [True, False])
def test_accumulator_step_matches_reference(adaptive):
    rng = np.random.default_rng(1)
    ours = GradientSharingAccumulator(257, 3, threshold=5e-3,
                                      adaptive=adaptive)
    ref = jgs.GradientSharingAccumulator(257, 3, threshold=5e-3,
                                         adaptive=adaptive)
    for _ in range(25):
        grads = [rng.standard_normal(257).astype(np.float32) * 0.01
                 for _ in range(3)]
        np.testing.assert_array_equal(ours.step(grads), ref.step(grads))
        assert ours.threshold == ref.threshold
        for w in range(3):
            np.testing.assert_array_equal(ours.residuals[w],
                                          ref.residuals[w])
            assert ours.residual_norm(w) == ref.residual_norm(w)


def _frame_bytes(send, *args):
    a, b = socket.socketpair()
    try:
        send(a, *args)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_gradient_and_scaleout_frames_byte_identical():
    tokens = np.array([0, 3, 8, 1 << 40], np.int64)
    assert _frame_bytes(transport._send_frame, tokens, 0.25) == \
        _frame_bytes(jtransport._send_frame, tokens, 0.25)
    payload = bytes(range(7))
    assert _frame_bytes(transport.send_frame, transport.KIND_PARAMS,
                        payload) == \
        _frame_bytes(jtransport.send_frame, jtransport.KIND_PARAMS, payload)
    a, b = socket.socketpair()
    try:
        jtransport._send_frame(a, tokens, 0.25)
        got, thr = transport._recv_frame(b)
    finally:
        a.close()
        b.close()
    np.testing.assert_array_equal(got, tokens)
    assert thr == 0.25


def test_port_and_reference_workers_share_one_hub():
    """A JAX worker and a port worker on one hub of either package: both
    decode the same mean, bit for bit, round after round."""
    rng = np.random.default_rng(2)
    ups = [[rng.standard_normal(64).astype(np.float32) * 0.01
            for _ in range(2)] for _ in range(10)]
    for server_cls in (GradientExchangeServer,
                       jtransport.GradientExchangeServer):
        server = server_cls(n_workers=2).start()
        outs = [[], []]

        def run(wid, tcls, wcls):
            t = tcls(server.address, timeout=WAIT_S)
            w = wcls(64, t, threshold=1e-3)
            for r in range(10):
                outs[wid].append(w.step(ups[r][wid]))
            t.close()

        try:
            _run_threads([
                lambda: run(0, SocketGradientTransport,
                            DistributedGradientWorker),
                lambda: run(1, jtransport.SocketGradientTransport,
                            jtransport.DistributedGradientWorker)])
        finally:
            server.stop()
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    from deeplearning4j_tpu_torch.parallel.transport import (
        DistributedGradientWorker, SocketGradientTransport)

    port = int(sys.argv[1]); wid = int(sys.argv[2]); out = sys.argv[3]
    rng = np.random.default_rng(0)           # same data layout in each proc
    X = rng.standard_normal((256, 64)).astype(np.float32)
    w_true = rng.standard_normal(64).astype(np.float32)
    y = X @ w_true
    lo, hi = (0, 128) if wid == 0 else (128, 256)
    Xw, yw = X[lo:hi], y[lo:hi]
    w = np.zeros(64, np.float32)             # identical init across workers
    transport = SocketGradientTransport(("127.0.0.1", port), timeout=120)
    worker = DistributedGradientWorker(64, transport, threshold=1e-3)
    losses = []
    for step in range(400):
        pred = Xw @ w
        losses.append(float(np.mean((pred - yw) ** 2)))
        grad = 2 * Xw.T @ (pred - yw) / len(yw)
        w -= worker.step((0.02 * grad).astype(np.float32))
    transport.close()
    np.savez(out, w=w, losses=np.asarray(losses),
             residual=worker.residual_norm(), threshold=worker.threshold)
""").format(repo=str(REPO))


@pytest.mark.slow
def test_two_process_encoded_training_matches_dense(tmp_path):
    server = GradientExchangeServer(n_workers=2).start()
    try:
        port = server.address[1]
        procs, outs = [], []
        for wid in range(2):
            out = tmp_path / f"w{wid}.npz"
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(port), str(wid),
                 str(out)], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for p in procs:
            _, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-2000:]
    finally:
        server.stop()
    assert server.rounds == 400
    r0, r1 = np.load(outs[0]), np.load(outs[1])
    np.testing.assert_array_equal(r0["w"], r1["w"])
    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 64)).astype(np.float32)
    w_true = rng.standard_normal(64).astype(np.float32)
    y = X @ w_true
    w = np.zeros(64, np.float32)
    for _ in range(400):
        grads = []
        for lo, hi in ((0, 128), (128, 256)):
            pred = X[lo:hi] @ w
            grads.append(2 * X[lo:hi].T @ (pred - y[lo:hi]) / (hi - lo))
        w -= 0.02 * (grads[0] + grads[1]) / 2
    dense_final = float(np.mean((X @ w - y) ** 2))
    sparse_final = float(r0["losses"][-1])
    initial = float(r0["losses"][0])
    assert sparse_final < 1e-4 * initial, (sparse_final, initial)
    assert sparse_final < max(2 * dense_final, 1e-3), (sparse_final,
                                                       dense_final)
    assert r0["residual"] >= 0
