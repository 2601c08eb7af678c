"""The port's DSP chain against the JAX package's.

``audio_raytracer_tpu_torch.models.spatializer.spatialize`` against JAX
``spatialize`` on the four cases of tests/test_dsp.py, with and without
the IR tail, across three consecutive buffers so the filter state and
the tail carry over, within test_dsp.py's rtol 2e-3 / atol 2e-4. The
doubling scan against a float64 sample loop (the recurrence as the C#
code runs it) at rtol 1e-4 / atol 1e-5; SampledCurve, ir_to_fir,
convolve_tail and bin_times against their JAX counterparts at rtol 1e-5
/ atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.models import spatializer as J
from audio_raytracer_tpu.ops import reverb as j_reverb
from audio_raytracer_tpu.types import TargetSettings as JSettings
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu.utils.curves import SampledCurve as JCurve
from audio_raytracer_tpu_torch.models import spatializer as T
from audio_raytracer_tpu_torch.ops import reverb as t_reverb
from audio_raytracer_tpu_torch.types import TargetSettings as TSettings
from audio_raytracer_tpu_torch.types import TraceConfig
from audio_raytracer_tpu_torch.utils.curves import SampledCurve as TCurve

torch.set_num_threads(1)

SR = 48000
CPU = "cpu"
SMALL = dict(rtol=1e-5, atol=1e-6)

# One compile per state structure (tail on or off) instead of an eager
# dispatch of every scan step.
j_spatialize = jax.jit(J.spatialize, static_argnames=("target_index",
                                                      "sample_rate"))

CASES = [
    dict(muffle=0.7, rv=0.4, dir=[0.5, -0.3, 0.8], dist=4.0),
    dict(muffle=0.0, rv=0.9, dir=[-0.6, 0.5, 0.6], dist=10.0),
    dict(muffle=1.0, rv=0.0, dir=[0.0, -1.0, 0.0], dist=2.0),
    dict(muffle=0.2, rv=0.5, dir=[0.9, 0.1, -0.4], dist=20.0),
]


def settings_pair(muffle, reverb_strength, reverb_volume):
    vals = dict(muffle=np.float32([muffle]),
                reverb_strength=np.float32(reverb_strength),
                reverb_volume=np.float32(reverb_volume),
                perceived_position=np.zeros((1, 3), np.float32))
    return (JSettings(**{k: jnp.asarray(v) for k, v in vals.items()}),
            TSettings(**{k: torch.as_tensor(v) for k, v in vals.items()}))


@pytest.mark.parametrize("tail", [False, True], ids=["dry", "tail"])
@pytest.mark.parametrize("case", CASES, ids=["c0", "c1", "c2", "c3"])
def test_spatialize_matches_jax_across_buffers(case, tail):
    rng = np.random.default_rng(3)
    d = np.asarray(case["dir"], np.float64)
    d = (d / np.linalg.norm(d)).astype(np.float32)
    dist = np.float32(case["dist"])
    jrt, trt = settings_pair(case["muffle"], 0.5, case["rv"])
    js, ts = J.SpatializerSettings.default(), \
        T.SpatializerSettings.default(device=CPU)
    tail_len = None
    ir = rng.uniform(0.0, 3.0, 32).astype(np.float32)
    if tail:
        js = dataclasses.replace(js, render_reverb_tail=True)
        ts = dataclasses.replace(ts, render_reverb_tail=True)
        tail_len = J.ir_kernel_length(32, 125.0, SR) - 1
        assert tail_len == T.ir_kernel_length(32, 125.0, SR) - 1
    jst, tst = J.DSPState.zero(tail_len), T.DSPState.zero(tail_len,
                                                          device=CPU)
    for _ in range(3):
        buf = (rng.standard_normal((1024, 2)) * 0.3).astype(np.float32)
        jout, jst, jdry = j_spatialize(
            jnp.asarray(buf), jst, js, jrt, target_index=0,
            local_dir=jnp.asarray(d), distance=jnp.asarray(dist),
            sample_rate=SR, reverb_ir=jnp.asarray(ir))
        tout, tst, tdry = T.spatialize(
            torch.as_tensor(buf), tst, ts, trt, 0, torch.as_tensor(d),
            torch.as_tensor(dist), SR, reverb_ir=torch.as_tensor(ir),
            device=CPU)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=2e-3, atol=2e-4)
        assert float(tdry) == float(jdry)
        for f in ("muffle_prev", "lp_prev", "hp_prev_out", "hp_prev_in"):
            np.testing.assert_allclose(getattr(tst, f).numpy(),
                                       np.asarray(getattr(jst, f)),
                                       rtol=2e-3, atol=2e-4, err_msg=f)
    if tail:
        np.testing.assert_allclose(tst.reverb_tail.numpy(),
                                   np.asarray(jst.reverb_tail), rtol=2e-3,
                                   atol=2e-4)
        assert float(np.abs(tst.reverb_tail.numpy()).max()) > 1e-3
    else:
        assert tst.reverb_tail is None


def sample_loop(x, prev, alpha, highpass, prev_in=None):
    """The one-pole recurrence sample by sample in float64
    (MuffleDSP.cs / BinauralDSP.cs:97-105)."""
    y = np.empty_like(x)
    p = prev.copy()
    xin = prev_in.copy() if highpass else None
    for i in range(len(x)):
        if highpass:
            p = alpha * (p + x[i] - xin)
            xin = x[i]
        else:
            p = p + alpha * (x[i] - p)
        y[i] = p
    return y


@pytest.mark.parametrize("highpass", [False, True], ids=["lp", "hp"])
@pytest.mark.parametrize("alpha", [1e-3, 0.5, 0.999])
def test_doubling_scan_matches_a_float64_sample_loop(alpha, highpass):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4096, 2)) * 0.3
    prev = np.array([0.25, -0.4])
    prev_in = np.array([0.1, 0.2])
    want = sample_loop(x, prev, alpha, highpass, prev_in)
    xt = torch.as_tensor(x, dtype=torch.float32)
    a = torch.tensor(alpha, dtype=torch.float32)
    if highpass:
        y, last, last_in = T._one_pole_hp(
            xt, torch.as_tensor(prev, dtype=torch.float32),
            torch.as_tensor(prev_in, dtype=torch.float32), a)
        np.testing.assert_array_equal(last_in.numpy(), xt[-1].numpy())
    else:
        y, last = T._one_pole_lp(
            xt, torch.as_tensor(prev, dtype=torch.float32), a)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(last.numpy(), y[-1].numpy())


def test_linear_scan_of_a_general_recurrence():
    rng = np.random.default_rng(6)
    a = rng.uniform(-1.0, 1.0, (1000, 3))
    b = rng.standard_normal((1000, 3))
    want = np.empty_like(b)
    y = np.zeros(3)
    for i in range(len(b)):
        y = a[i] * y + b[i]
        want[i] = y
    got = T.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("curve", ["linear", "from_fn"])
def test_sampled_curve_matches_jax(curve):
    times = np.float32([-0.5, 0.0, 0.013, 0.37, 0.5, 0.99, 1.0, 1.7, 2.4])
    if curve == "linear":
        j, t = JCurve.linear(), TCurve.linear(device=CPU)
    else:
        j = JCurve.from_fn(lambda x: jnp.sqrt(x), k=17, length=2.0,
                           value_multiplier=3.0)
        t = TCurve.from_fn(torch.sqrt, k=17, length=2.0,
                           value_multiplier=3.0, device=CPU)
    np.testing.assert_allclose(t.samples.numpy(), np.asarray(j.samples),
                               **SMALL)
    np.testing.assert_allclose(t.evaluate(torch.as_tensor(times)).numpy(),
                               np.asarray(j.evaluate(jnp.asarray(times))),
                               **SMALL)


def test_ir_to_fir_and_convolve_tail_match_jax():
    rng = np.random.default_rng(7)
    ir = rng.uniform(0.0, 2.0, 24).astype(np.float32)
    ir[3] = 0.0
    L = J.ir_kernel_length(24, 90.0, SR)
    jh = J.ir_to_fir(jnp.asarray(ir), jnp.float32(90.0), SR, L)
    th = T.ir_to_fir(torch.as_tensor(ir), torch.tensor(90.0), SR, L)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SMALL)
    assert np.count_nonzero(th.numpy()) == 23

    x = (rng.standard_normal((512, 2)) * 0.3).astype(np.float32)
    carry = (rng.standard_normal((L - 1, 2)) * 0.1).astype(np.float32)
    jw, jt = J.convolve_tail(jnp.asarray(x), jh, jnp.asarray(carry))
    tw, tt = T.convolve_tail(torch.as_tensor(x), th, torch.as_tensor(carry))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4,
                               atol=1e-5)


def test_empty_ir_gives_a_silent_fir():
    h = T.ir_to_fir(torch.zeros(8), torch.tensor(125.0), SR, 100)
    assert h.shape == (100,) and float(h.abs().sum()) == 0.0


def test_bin_times_and_speed_of_sound_match_jax():
    assert t_reverb.SPEED_OF_SOUND == j_reverb.SPEED_OF_SOUND
    kw = dict(num_reverb_bins=40, ir_max_distance=150.0)
    np.testing.assert_allclose(
        t_reverb.bin_times(TraceConfig(**kw), device=CPU).numpy(),
        np.asarray(j_reverb.bin_times(JConfig(**kw))), **SMALL)


def test_dsp_builders_default_to_the_card(monkeypatch):
    ts = T.SpatializerSettings.default(device=CPU)
    st = T.DSPState.zero(device=CPU)
    _, rt = settings_pair(0.5, 0.5, 0.5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (T.SpatializerSettings.default, T.DSPState.zero,
                  TCurve.linear):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.spatialize(torch.zeros(16, 2), st, ts, rt, 0,
                     torch.tensor([0.0, 0.0, 1.0]), torch.tensor(2.0), SR)
    with pytest.raises(ValueError):
        T.spatialize(torch.zeros(16, 2, device="meta"), st, ts, rt, 0,
                     torch.tensor([0.0, 0.0, 1.0]), torch.tensor(2.0), SR,
                     device=CPU)
