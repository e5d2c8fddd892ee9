"""The port's HTTP serving daemon over a real server on the CPU: transport,
micro-batching, certificates, and the five faults of the JAX daemon.

Counterpart of ``tests/test_serve.py``: a fixed-batch artifact (exported
from a checkpoint of the port by ``cli.serve --ckpt``) behind the real
``ThreadingHTTPServer`` on a loopback port, driven by standard-library
clients, against the port's eager ``Predictor`` on the same weights (labels
equal bit for bit: the artifact runs the Predictor's operators in its
order). No JAX here: the JAX daemon's behaviour is what the tests name.

One test a fault that ``ADVICE.md`` lists in ``pointnet2_tpu/serving.py``,
each failing on a line-for-line copy of it: the unread body of a POST to an
unknown path (``:248``), the shared fate of a coalesced round (``:215``),
the 500 for zero clouds (``:226``), the unbounded wait after stop
(``:258``) and the rounds counted as device batches (``:180``).
"""

import http.client
import io
import json
import math
import shutil
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch.cli import serve as cli_serve
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.serving import MicroBatcher, PredictServer, ServerStats, ServingModel
from pointnet2_tpu_torch.train import Trainer, save_checkpoint

SMALL = dict(num_point=256, batch_size=4, l1_npoint=64, l2_npoint=32, l3_npoint=16, l4_npoint=8)
NPY = "application/x-npy"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A server of a batch-4 artifact exported by ``cli.serve --ckpt``, and
    the eager Predictor of the same weights."""
    root = tmp_path_factory.mktemp("serve")
    trainer = Trainer(Config(**SMALL), device="cpu")
    trainer.init_state(0, bn_stats="random")
    save_checkpoint(root / "model.pt", trainer)
    (root / "small.json").write_text(json.dumps(SMALL))
    server = cli_serve.build_server([
        "--ckpt", str(root / "model.pt"), "--config_file", str(root / "small.json"), "--batch", "4",
        "--device", "cpu", "--port", "0", "--max_delay_ms", "30",
    ])
    server.start_background()
    yield server, Predictor(trainer.cfg, trainer.model.state_dict(), device="cpu")
    server.shutdown()
    shutil.rmtree(server.artifact_dir, ignore_errors=True)


def _clouds(seed, b):
    return np.random.RandomState(seed).randn(b, SMALL["num_point"], 6).astype(np.float32)


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _post(port, body, ctype="application/json", accept=None, path="/v1/predict"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    req.add_header("Content-Type", ctype)
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _live(predictor, pts):
    return predictor.predict_step(pts).numpy()


def _with_certificate(server, passes):
    """Make ``server``'s artifact report a certificate: ``passes(x)`` on each device call's batch."""
    real = server.model._fn
    server.model.checked = True
    server.model._fn = lambda x: (real(x), torch.tensor(passes(x)))


def test_healthz_and_stats(served):
    server, _ = served
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok"
    assert health["manifest"]["input_shape"] == [4, 256, 6] and health["manifest"]["device"] == "cpu"
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
        assert "device_batches" in json.loads(r.read())


def test_json_single_cloud_matches_live(served):
    server, predictor = served
    pts = _clouds(1, 1)
    status, body, _ = _post(server.port, json.dumps({"points": pts[0].tolist()}).encode())
    assert status == 200
    np.testing.assert_array_equal(np.asarray(json.loads(body)["labels"], np.int32), _live(predictor, pts))


def test_npy_batch_round_trip(served):
    server, predictor = served
    pts = _clouds(2, 2)
    status, body, ctype = _post(server.port, _npy(pts), ctype=NPY, accept=NPY)
    assert status == 200 and ctype == NPY
    got = np.load(io.BytesIO(body))
    assert got.shape == (2, SMALL["num_point"])
    np.testing.assert_array_equal(got, _live(predictor, pts))


def test_oversize_request_is_split_across_device_calls(served):
    # 7 clouds > the artifact's batch of 4: two calls, 4 and 3 (+1 padding)
    server, predictor = served
    pts = _clouds(3, 7)
    status, body, _ = _post(server.port, _npy(pts), ctype=NPY)
    assert status == 200
    np.testing.assert_array_equal(np.asarray(json.loads(body)["labels"], np.int32), _live(predictor, pts))


def test_concurrent_requests_are_microbatched(served):
    server, _ = served
    before = server.stats.snapshot()
    body = json.dumps({"points": _clouds(4, 1)[0].tolist()}).encode()
    with ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(lambda _: _post(server.port, body), range(4)))
    assert all(s == 200 for s, _, _ in results)
    assert len({b for _, b, _ in results}) == 1  # the same cloud, the same answer
    after = server.stats.snapshot()
    assert after["requests"] - before["requests"] == 4
    # a 30 ms coalescing window: four concurrent one-cloud requests share device batches
    assert after["device_batches"] - before["device_batches"] < 4
    assert after["batched_clouds"] > before["batched_clouds"]


def test_bad_shape_is_400(served):
    server, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.port, json.dumps({"points": [[1.0, 2.0], [3.0, 4.0]]}).encode())
    assert ei.value.code == 400
    assert json.loads(ei.value.read())["error"] == "bad_request"


def test_unknown_path_is_404(served):
    server, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.port, b"{}", path="/v2/nope")
    assert ei.value.code == 404


def test_certificate_failure_is_503(served):
    server, _ = served
    srv = PredictServer(server.artifact_dir, port=0, max_delay_ms=1.0, warmup=False)
    _with_certificate(srv, lambda x: False)
    srv.start_background()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, json.dumps({"points": _clouds(5, 1)[0].tolist()}).encode())
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["error"] == "window_certificate_failed"
        assert srv.stats.snapshot()["certificate_failures"] == 1
    finally:
        srv.shutdown()


def test_symbolic_artifact_pads_to_pow2(served):
    """A symbolic-batch artifact's calls are padded to the next power of two,
    up to ``max_batch`` (the batches a symbolic artifact is called with,
    recorded around the eager forward; ``tests/test_torch_export.py`` runs a
    symbolic artifact at B = 1, 3 and 4)."""
    server, predictor = served
    model = ServingModel(server.artifact_dir, max_batch=8)
    calls = []
    model.fixed_batch, model.max_batch = None, 8
    model._fn = lambda x: calls.append(x.shape[0]) or predictor.predict_step(x)
    pts = _clouds(6, 11)
    labels, ok, oks = model.run(pts[:3])
    assert ok and oks == [True] and labels.shape == (3, SMALL["num_point"])
    np.testing.assert_array_equal(labels, _live(predictor, pts[:3]))
    labels, ok, oks = model.run(pts)
    assert calls == [4, 8, 4] and oks == [True, True]
    np.testing.assert_array_equal(labels, _live(predictor, pts))


# -- the five faults of pointnet2_tpu/serving.py (ADVICE.md) ------------------


def test_unknown_path_body_is_read_before_the_404(served):
    """``:248``: on a kept-alive connection the next request must parse."""
    server, predictor = served
    pts = _clouds(7, 1)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.request("POST", "/v2/nope", body=json.dumps({"points": pts[0].tolist()}),
                     headers={"Content-Type": "application/json"})
        first = conn.getresponse()
        first.read()
        assert first.status == 404
        conn.request("POST", "/v1/predict", body=_npy(pts), headers={"Content-Type": NPY})
        second = conn.getresponse()
        body = second.read()
        assert second.status == 200
        np.testing.assert_array_equal(np.asarray(json.loads(body)["labels"], np.int32), _live(predictor, pts))
    finally:
        conn.close()


def test_a_failing_request_does_not_fail_its_round(served):
    """``:215``: a cloud that fails its certificate and one that passes, in
    one round, get 503 and 200."""
    server, predictor = served
    srv = PredictServer(server.artifact_dir, port=0, max_delay_ms=500.0, warmup=False)
    _with_certificate(srv, lambda x: bool((x[..., 0] < 100.0).all()))
    srv.start_background()
    good, bad = _clouds(8, 1), _clouds(9, 1)
    bad[..., 0] += 1000.0
    go = threading.Barrier(2)

    def post(pts):
        go.wait(timeout=30)
        try:
            status, body, _ = _post(srv.port, _npy(pts), ctype=NPY, accept=NPY)
            return status, np.load(io.BytesIO(body))
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            (good_status, labels), (bad_status, payload) = ex.map(post, (good, bad))
        assert srv.stats.snapshot()["batched_clouds"] == 2  # the two shared a round
        assert good_status == 200 and bad_status == 503
        np.testing.assert_array_equal(labels, _live(predictor, good))
        assert payload["error"] == "window_certificate_failed"
    finally:
        srv.shutdown()


def test_zero_clouds_is_400(served):
    """``:226``: an empty batch is the client's error, not the server's."""
    server, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.port, _npy(np.zeros((0, SMALL["num_point"], 6), np.float32)), ctype=NPY)
    assert ei.value.code == 400
    assert json.loads(ei.value.read())["error"] == "bad_request"


def test_submit_after_stop_fails_at_once(served):
    """``:258``: a request that reaches a stopped batcher is answered, not left waiting."""
    server, _ = served
    batcher = MicroBatcher(server.model, ServerStats(), max_delay_ms=1.0)
    batcher.stop()
    pending = batcher.submit(_clouds(10, 1))
    assert pending.event.wait(timeout=5)
    assert pending.error is not None and pending.labels is None


def test_oversize_request_counts_each_device_call(served):
    """``:180``: a request of b clouds on a batch-4 artifact is ceil(b / 4) device batches."""
    server, predictor = served
    before = server.stats.snapshot()
    pts = _clouds(11, 9)
    status, body, _ = _post(server.port, _npy(pts), ctype=NPY, accept=NPY)
    assert status == 200
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), _live(predictor, pts))
    after = server.stats.snapshot()
    assert after["device_batches"] - before["device_batches"] == math.ceil(9 / 4)
    assert after["clouds"] - before["clouds"] == 9


def test_serve_cli_flags(served):
    """Exactly one of --artifact/--ckpt; an artifact is served on its own device."""
    server, _ = served
    for argv in ([], ["--artifact", server.artifact_dir, "--ckpt", "x.pt"]):
        with pytest.raises(SystemExit):
            cli_serve.build_server(argv)
    with pytest.raises(ValueError, match="exported for cpu"):
        cli_serve.build_server(["--artifact", server.artifact_dir, "--device", "cuda", "--port", "0"])
