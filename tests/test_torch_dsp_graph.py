"""The DSP chain under a graph (``models/spatializer.py::make_spatialize``,
``SpatializeGraph``) on the CPU.

On the card ``make_spatialize`` returns a ``SpatializeGraph``, one
captured CUDA graph a buffer; on the CPU the eager ``spatialize``. These
tests build the graph object on the CPU too: its warm-up and "replays"
run the chain on its static buffers, so the copy in, the device target
index, the fresh state copied out and the key run here as on the card.
Two targets alternate through one step object over 4 carried buffers
each, with the IR tail on and off, at a volume multiplier of 0.8. Each
buffer is held bit for bit to eager ``spatialize`` and to the JAX
package's ``spatialize`` jitted as its player jits it
(demo/scene_player.py:161) within tests/test_torch_dsp.py's rtol 2e-3 /
atol 2e-4.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.models import spatializer as J
from audio_raytracer_tpu.types import TargetSettings as JSettings
from audio_raytracer_tpu_torch.models import spatializer as T
from audio_raytracer_tpu_torch.types import TargetSettings as TSettings

torch.set_num_threads(1)

SR = 48000.0
CPU = "cpu"
VOLUME = 0.8
BUFFERS = 4
N = 1024
DSP = dict(rtol=2e-3, atol=2e-4)  # tests/test_torch_dsp.py's

j_spatialize = jax.jit(J.spatialize,
                       static_argnames=("sample_rate", "volume_multiplier"))

# Two targets: one muffled, above the listener; one open, below it.
TARGETS = [dict(dir=[0.5, 0.3, 0.8], dist=4.0),
           dict(dir=[-0.6, -0.5, 0.6], dist=12.0)]
RT = dict(muffle=np.float32([0.7, 0.0]), reverb_strength=np.float32(0.5),
          reverb_volume=np.float32(0.4),
          perceived_position=np.zeros((2, 3), np.float32))
STATE_FIELDS = ("muffle_prev", "lp_prev", "hp_prev_out", "hp_prev_in",
                "reverb_tail")


def unit(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def settings_of(tail):
    t = T.SpatializerSettings.default(device=CPU)
    j = J.SpatializerSettings.default()
    return (dataclasses.replace(t, render_reverb_tail=tail),
            dataclasses.replace(j, render_reverb_tail=tail))


def tail_len(tail):
    return T.ir_kernel_length(32, 125.0, SR) - 1 if tail else None


def state_arrays(st):
    return {f: getattr(st, f).numpy().copy() for f in STATE_FIELDS
            if getattr(st, f) is not None}


def stream(tail, step):
    """BUFFERS buffers of both targets in turns through ``step`` (the
    graph object or the eager closure), beside eager ``spatialize`` and
    JAX's jitted one on the same inputs. Returns the outputs per buffer
    and target, and each state passed in with its values at the call."""
    rng = np.random.default_rng(11)
    ts, js = settings_of(tail)
    trt = TSettings(**{k: torch.as_tensor(v) for k, v in RT.items()})
    jrt = JSettings(**{k: jnp.asarray(v) for k, v in RT.items()})
    ir = rng.uniform(0.0, 3.0, 32).astype(np.float32)
    L = tail_len(tail)
    graph_st = [T.DSPState.zero(L, device=CPU) for _ in TARGETS]
    eager_st = [T.DSPState.zero(L, device=CPU) for _ in TARGETS]
    jax_st = [J.DSPState.zero(L) for _ in TARGETS]
    out = []
    for b in range(BUFFERS):
        buf = (rng.standard_normal((N, 2)) * 0.3).astype(np.float32)
        for ti, tgt in enumerate(TARGETS):
            d, dist = unit(tgt["dir"]), np.float32(tgt["dist"])
            held = state_arrays(graph_st[ti])
            g = step(torch.as_tensor(buf), graph_st[ti], trt, ti,
                     torch.as_tensor(d), torch.as_tensor(dist),
                     reverb_ir=torch.as_tensor(ir))
            e = T.spatialize(torch.as_tensor(buf), eager_st[ti], ts, trt, ti,
                             torch.as_tensor(d), torch.as_tensor(dist), SR,
                             VOLUME, reverb_ir=torch.as_tensor(ir),
                             device=CPU)
            j = j_spatialize(jnp.asarray(buf), jax_st[ti], js, jrt, ti,
                             jnp.asarray(d), jnp.asarray(dist),
                             sample_rate=SR, volume_multiplier=VOLUME,
                             reverb_ir=jnp.asarray(ir))
            out.append(dict(buffer=b, target=ti, graph=g, eager=e, jax=j,
                            held=held, passed=graph_st[ti]))
            graph_st[ti], eager_st[ti], jax_st[ti] = g[1], e[1], j[1]
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["dry", "tail"])
def graphed(request):
    """(the graph object, its stream) with the tail off or on."""
    tail = request.param
    step = T.SpatializeGraph(settings_of(tail)[0], SR, VOLUME, device=CPU)
    return tail, step, stream(tail, step)


def test_graph_buffers_equal_eager_spatialize_bit_for_bit(graphed):
    _, _, calls = graphed
    for c in calls:
        (gy, gs, gd), (ey, es, ed) = c["graph"], c["eager"]
        assert torch.equal(gy, ey), (c["buffer"], c["target"])
        assert torch.equal(gd, ed)
        for f in STATE_FIELDS:
            a, b = getattr(gs, f), getattr(es, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b), f


def test_graph_buffers_match_jitted_jax_spatialize(graphed):
    tail, _, calls = graphed
    for c in calls:
        (gy, gs, gd), (jy, jst, jd) = c["graph"], c["jax"]
        np.testing.assert_allclose(gy.numpy(), np.asarray(jy), **DSP)
        assert float(gd) == float(jd)
        for f in STATE_FIELDS:
            a, b = getattr(gs, f), getattr(jst, f)
            assert (a is None) == (b is None) == (f == "reverb_tail"
                                                  and not tail)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **DSP,
                                           err_msg=f)
    last = calls[-1]["graph"][1]
    if tail:
        assert float(last.reverb_tail.abs().max()) > 1e-3


def test_targets_share_one_graph(graphed):
    """Both targets through one key: one warm-up, one capture, every
    later buffer a replay; the targets' outputs differ."""
    _, step, calls = graphed
    assert (step.warmups, step.captures, step.replays) == (
        1, 1, 2 * BUFFERS - 1)
    assert not torch.equal(calls[0]["graph"][0], calls[1]["graph"][0])


def test_the_callers_state_is_never_written(graphed):
    """Every state passed in keeps its values to the end of the stream,
    and no tensor of a state returned is the static buffers' or another
    call's."""
    _, step, calls = graphed
    seen = set()
    for c in calls:
        now = state_arrays(c["passed"])
        assert c["held"].keys() == now.keys()
        for f, v in c["held"].items():
            np.testing.assert_array_equal(now[f], v, err_msg=f)
        new = [t for t in (getattr(c["graph"][1], f) for f in STATE_FIELDS)
               if t is not None]
        ptrs = {t.data_ptr() for t in new}
        assert not ptrs & seen
        seen |= ptrs
        static = {t.data_ptr() for x in step._inputs if x is not None
                  for t in T.tensors_of(x)}
        assert not ptrs & static


def test_a_settings_change_makes_a_new_key():
    settings = settings_of(True)[0]
    step = T.SpatializeGraph(settings, SR, VOLUME, device=CPU)
    rt = TSettings(**{k: torch.as_tensor(v) for k, v in RT.items()})
    st = T.DSPState.zero(tail_len(True), device=CPU)
    ir = torch.rand(32, generator=torch.Generator().manual_seed(2))
    buf = torch.randn((N, 2), generator=torch.Generator().manual_seed(3))
    d, dist = torch.as_tensor(unit([0.1, 0.2, 1.0])), torch.tensor(5.0)

    def call(**kw):
        return step(buf, st, rt, 1, d, dist, **kw)

    call(reverb_ir=ir)
    call(reverb_ir=ir)
    key = step.key
    call(reverb_ir=ir.clone())  # new values, the same key
    assert step.key == key and step.captures == 1
    keys = [key]
    # A new tensor in the settings, a boolean, no IR, a new volume: each
    # a new key, and the buffer still that of eager spatialize.
    for change in ("tensor", "boolean", "no ir", "volume"):
        kw = dict(reverb_ir=ir)
        if change == "tensor":
            step.settings = dataclasses.replace(
                step.settings, pan_strength=torch.tensor(0.3))
        elif change == "boolean":
            step.settings = dataclasses.replace(
                step.settings, distance_based_panning=False)
        elif change == "no ir":
            kw = {}
        else:
            step.volume_multiplier = 0.5
        got = call(**kw)
        assert step.key not in keys, change
        keys.append(step.key)
        want = T.spatialize(buf, st, step.settings, rt, 1, d, dist, SR,
                            step.volume_multiplier, device=CPU, **kw)
        assert torch.equal(got[0], want[0]), change
    assert step.warmups == 5


def test_make_spatialize_picks_the_graph_on_the_card():
    settings = settings_of(False)[0]
    step = T.make_spatialize(settings, SR, VOLUME, device=CPU)
    assert not isinstance(step, T.SpatializeGraph)
    rt = TSettings(**{k: torch.as_tensor(v) for k, v in RT.items()})
    st = T.DSPState.zero(device=CPU)
    buf = torch.randn((N, 2), generator=torch.Generator().manual_seed(4))
    d, dist = torch.as_tensor(unit([0.3, 0.1, -1.0])), torch.tensor(2.0)
    got = step(buf, st, rt, 0, d, dist)
    want = T.spatialize(buf, st, settings, rt, 0, d, dist, SR, VOLUME,
                        device=CPU)
    assert all(torch.equal(a, b) for a, b in
               ((got[0], want[0]), (got[2], want[2])))
    with mock.patch.object(torch.cuda, "is_available", return_value=True):
        card = T.make_spatialize(settings, SR, VOLUME, device="cuda")
    assert isinstance(card, T.SpatializeGraph) and card.key is None
    assert (card.sample_rate, card.volume_multiplier) == (SR, VOLUME)
