"""The port's serving daemon (exp/serving.py) on CPU: HTTP round trips
through the batching executor, zero-padding of partial batches, and the
400 on a malformed request. Same npz wire format as the JAX daemon."""

import io

import numpy as np
import pytest
import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.exp.export import (
    make_serving_fn,
    random_serving_inputs,
    serving_input_specs,
)
from maavss_tpu_torch.exp.serving import (
    BatchingExecutor,
    SeparationClient,
    SeparationServer,
)
from maavss_tpu_torch.train.setup import build_fusion
from tests.test_torch_workers import share_cores

share_cores()

SMALL = dict(num_frames=4, num_seq=4, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=2)


@pytest.fixture(scope="module")
def server():
    cfg = RunConfig(**SMALL)
    model = build_fusion(cfg, 2, "cpu")
    fn = make_serving_fn(model, cfg)
    a_spec, v_spec = serving_input_specs(cfg, 2)
    executor = BatchingExecutor(fn, 2, a_spec, v_spec, "cpu", max_wait_ms=1.0)
    srv = SeparationServer(executor, {"model": "fusion", "batch": 2},
                           host="127.0.0.1", port=0).start()
    client = SeparationClient("http://%s:%d" % srv.address)
    yield cfg, fn, client
    client.close()
    srv.stop()


def _request(cfg, rows, seed):
    audio, visual = random_serving_inputs(cfg, rows, seed=seed)
    visual = np.random.default_rng(seed).uniform(0, 1, visual.shape).astype(
        np.float32)
    return audio, visual


def _padded(fn, audio, visual, batch=2):
    a = np.zeros((batch,) + audio.shape[1:], np.float32)
    v = np.zeros((batch,) + visual.shape[1:], np.float32)
    a[:len(audio)], v[:len(visual)] = audio, visual
    return fn(torch.from_numpy(a), torch.from_numpy(v))[:len(audio)].numpy()


@pytest.mark.parametrize("rows", [1, 2])
def test_round_trip_matches_direct_call(server, rows):
    cfg, fn, client = server
    audio, visual = _request(cfg, rows, seed=rows)
    out = client.separate(audio, visual)
    assert out.shape == audio.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, _padded(fn, audio, visual), atol=1e-6,
                               rtol=0)


def test_stats_and_healthz(server):
    cfg, fn, client = server
    client.separate(*_request(cfg, 1, seed=9))
    stats = client.get_json("/stats")
    assert stats["requests"] >= 1 and stats["rows_padded"] >= 1
    assert client.get_json("/healthz")["ok"] is True


def test_bad_shape_is_400(server):
    cfg, fn, client = server
    audio, visual = _request(cfg, 1, seed=0)
    buf = io.BytesIO()
    np.savez(buf, audio=audio[:, :-5], visual=visual)
    status, body = client._roundtrip("POST", "/v1/separate", buf.getvalue())
    assert status == 400 and b"audio row shape" in body


def test_float16_rows_cross_the_wire_unchanged():
    """Under --pgram_cache the visual payload is float16 phasegram rows: the
    npz wire and the executor hand them to the serving function bit for
    bit (zero rows padding the batch), and a float32 payload is refused by
    the spec's dtype check."""
    cfg = RunConfig(**SMALL, pgram_cache=True)
    a_spec, v_spec = serving_input_specs(cfg, 2)
    assert v_spec.dtype == np.float16 and v_spec.shape == (2, 8, 256)
    seen = []

    def record(audio, visual):
        seen.append(visual.clone())
        return audio

    executor = BatchingExecutor(record, 2, a_spec, v_spec, "cpu",
                                max_wait_ms=1.0)
    srv = SeparationServer(executor, {"model": "fusion", "batch": 2},
                           host="127.0.0.1", port=0).start()
    client = SeparationClient("http://%s:%d" % srv.address)
    try:
        audio, rows = random_serving_inputs(cfg, 1, seed=5)
        assert rows.dtype == np.float16
        out = client.separate(audio, rows)
        np.testing.assert_array_equal(out, audio)
        assert seen[0].dtype == torch.float16
        np.testing.assert_array_equal(seen[0][:1].numpy(), rows)
        assert not seen[0][1:].any()
        buf = io.BytesIO()
        np.savez(buf, audio=audio, visual=rows.astype(np.float32))
        status, body = client._roundtrip("POST", "/v1/separate",
                                         buf.getvalue())
        assert status == 400 and b"dtype" in body
    finally:
        client.close()
        srv.stop()
