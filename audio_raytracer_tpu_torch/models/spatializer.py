"""Per-source DSP chain: muffle low-pass -> reverb dry-boost -> binaural.

The PyTorch counterpart of ``audio_raytracer_tpu/models/spatializer.py``,
the functional re-design of the reference audio-thread chain
(Audio/AudioTarget/AudioSpatializer.cs:70-87, MuffleDSP.cs, ReverbDSP.cs,
BinauralDSP.cs). Each one-pole IIR is a *linear recurrence*
y_i = a_i y_{i-1} + b_i, evaluated by ``linear_scan``, a log-depth
doubling scan over the affine pairs (a, b) with the combine of the JAX
package's ``associative_scan``, and the filter state threads across
buffers exactly like the C# structs' fields. The chain is plain tensor
code on one device; there is no kernel of its own.

Semantics replicated:
- Muffle LP: cutoff = lerp(cutoff_MAX, cutoff_MIN, curve(muffleStrength)),
  applied only when muffleStrength > 0 (MuffleDSP.cs:13-45).
- Reverb: dry-boost gain = lerp(min, max, curve(reverbVolume))
  (ReverbDSP.cs:10-24); the Unity AudioReverbFilter dryLevel mapping
  (AudioSpatializer.cs:58) is returned as ``reverb_dry_level``.
- Binaural: equal-power pan from azimuth (optionally distance-scaled),
  rear attenuation, elevation volume, then below-horizon LP or
  above-horizon HP with distance-scaled cutoffs (BinauralDSP.cs:15-105).
  Per the reference, only the active branch's filter state advances.
- The IR-driven reverb tail: the tracer's impulse response convolved
  with the buffer by FFT overlap-add (``ir_to_fir``, ``convolve_tail``).

``make_spatialize`` is the counterpart of the JAX player's
``jax.jit(spatialize, static_argnames=("sample_rate",
"volume_multiplier"))`` (demo/scene_player.py:161): on the card a
``SpatializeGraph``, the chain captured as one CUDA graph and replayed
per buffer.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from audio_raytracer_tpu_torch.models.frame_graph import (
    CapturedCall,
    _copy_out,
    _describe,
)
from audio_raytracer_tpu_torch.ops.reverb import SPEED_OF_SOUND
from audio_raytracer_tpu_torch.types import (
    TargetSettings,
    check_device,
    map_tensors,
    resolve_device,
    tensors_of,
)
from audio_raytracer_tpu_torch.utils.curves import SampledCurve

Tensor = torch.Tensor

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class MinMax:
    min: Tensor
    max: Tensor

    @staticmethod
    def of(lo, hi, device="cuda"):
        dev = resolve_device(device)
        return MinMax(torch.tensor(lo, dtype=torch.float32, device=dev),
                      torch.tensor(hi, dtype=torch.float32, device=dev))

    def lerp(self, t):
        return self.min + (self.max - self.min) * t


@dataclasses.dataclass(frozen=True)
class SpatializerSettings:
    """All DSP tunables (DataTypes/AudioSpatializerSettings.cs:4-44).

    The bools are Python values (the serialized toggles); every number is
    a tensor on one device."""

    pan_strength: Tensor
    rear_attenuation_strength: Tensor
    distance_based_panning: bool = True
    max_pan_distance: Tensor = None
    distance_based_rear_attenuation: bool = True
    max_rear_attenuation_distance: Tensor = None
    max_elevation_effect_distance: Tensor = None
    low_pass_cutoff: MinMax = None
    low_pass_volume: Tensor = None
    high_pass_cutoff: MinMax = None
    high_pass_volume: Tensor = None
    muffle_curve: SampledCurve = None
    muffle_cutoff: MinMax = None
    reverb_dry_level: MinMax = None
    reverb_strength_curve: SampledCurve = None
    reverb_dry_boost: MinMax = None
    reverb_volume_curve: SampledCurve = None
    # The IR-driven reverb tail (the JAX package's upgrade of the
    # reference's delegation to Unity's AudioReverbFilter): the source is
    # convolved with the tracer's impulse response.
    render_reverb_tail: bool = False
    # Wet level = reverb_wet_level.lerp(strength_curve(reverb_strength)).
    reverb_wet_level: MinMax = None
    # Echo-distance window the IR bins span (must match the tracer's
    # TraceConfig.ir_max_distance so bin -> arrival-time mapping agrees).
    reverb_ir_max_distance: Tensor = None

    @staticmethod
    def default(device="cuda") -> "SpatializerSettings":
        """The shipped Default asset values
        (AudioSpatializerSettings.Default, cs:47-73)."""
        dev = resolve_device(device)

        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        def mm(lo, hi):
            return MinMax.of(lo, hi, dev)

        return SpatializerSettings(
            pan_strength=f(0.8),
            rear_attenuation_strength=f(0.2),
            distance_based_panning=True,
            max_pan_distance=f(5.0),
            distance_based_rear_attenuation=True,
            max_rear_attenuation_distance=f(15.0),
            max_elevation_effect_distance=f(12.0),
            low_pass_cutoff=mm(5000.0, 22000.0),
            low_pass_volume=f(0.85),
            high_pass_cutoff=mm(25.0, 150.0),
            high_pass_volume=f(1.15),
            muffle_curve=SampledCurve.linear(device=dev),
            muffle_cutoff=mm(75.0, 8000.0),
            reverb_dry_level=mm(0.0, -2000.0),
            reverb_strength_curve=SampledCurve.linear(device=dev),
            reverb_dry_boost=mm(1.0, 3.0),
            reverb_volume_curve=SampledCurve.linear(device=dev),
            reverb_wet_level=mm(0.0, 0.5),
            reverb_ir_max_distance=f(125.0),
        )


@dataclasses.dataclass(frozen=True)
class DSPState:
    """Per-source filter memories (the C# struct fields), stereo pairs.

    ``reverb_tail`` is the overlap-add carry of the IR convolution stage:
    the last L-1 convolved samples that extend past the current buffer
    ([L-1, 2]; None when the tail stage is off). Size it with
    ``DSPState.zero(tail_len=ir_kernel_length(...) - 1)``.
    """

    muffle_prev: Tensor  # [2]
    lp_prev: Tensor  # [2]
    hp_prev_out: Tensor  # [2]
    hp_prev_in: Tensor  # [2]
    reverb_tail: Tensor | None = None  # [L-1, 2]

    @staticmethod
    def zero(tail_len: int | None = None, device="cuda") -> "DSPState":
        dev = resolve_device(device)
        z = torch.zeros((2,), device=dev)
        # tail_len == 0 is a valid 1-tap FIR (L = 1): keep the [0, 2]
        # carry so the tail stage still runs; only None disables it.
        tail = (torch.zeros((tail_len, 2), device=dev)
                if tail_len is not None else None)
        return DSPState(z, z, z, z, tail)


def _combine(left, right):
    """The composition of two affine maps y -> a y + b, ``left`` first."""
    return left[0] * right[0], right[0] * left[1] + right[1]


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """y_i = a_i y_{i-1} + b_i along axis 0 with y_{-1} = 0.

    An inclusive Hillis-Steele doubling scan over the affine pairs (a, b):
    after the step of offset k, pair i holds the composition of the maps
    i-2k+1 .. i, so log2(N) steps of whole-tensor products suffice. It
    never divides, so it stays exact where a cumulative product of
    (1 - alpha) underflows."""
    n = a.shape[0]
    k = 1
    while k < n:
        ca, cb = _combine((a[:-k], b[:-k]), (a[k:], b[k:]))
        a = torch.cat([a[:k], ca])
        b = torch.cat([b[:k], cb])
        k *= 2
    return b


def _one_pole_lp(x: Tensor, prev: Tensor, alpha: Tensor):
    """y_i = y_{i-1} + alpha (x_i - y_{i-1}) over axis 0, the affine maps
    y -> (1-alpha) y + alpha x_i. x: [N, 2], prev: [2]. Returns
    (y [N, 2], new_prev [2])."""
    a = torch.broadcast_to(1.0 - alpha, x.shape)
    b = alpha * x
    # Fold the initial state into the first input.
    b = torch.cat([b[:1] + a[:1] * prev, b[1:]])
    y = linear_scan(a, b)
    return y, y[-1]


def _one_pole_hp(x: Tensor, prev_out: Tensor, prev_in: Tensor,
                 alpha: Tensor):
    """y_i = alpha (y_{i-1} + x_i - x_{i-1}) (BinauralDSP.cs:97-105)."""
    x_prev = torch.cat([prev_in[None, :], x[:-1]], dim=0)
    a = torch.broadcast_to(alpha, x.shape)
    b = alpha * (x - x_prev)
    b = torch.cat([b[:1] + a[:1] * prev_out, b[1:]])
    y = linear_scan(a, b)
    return y, y[-1], x[-1]


def ir_kernel_length(num_bins: int, ir_max_distance: float,
                     sample_rate: float) -> int:
    """FIR length L covering the last IR bin's center arrival time."""
    width = ir_max_distance / SPEED_OF_SOUND / num_bins
    return int(round((num_bins - 0.5) * width * sample_rate)) + 1


def ir_to_fir(reverb_ir: Tensor, ir_max_distance, sample_rate,
              length: int) -> Tensor:
    """[L] amplitude-domain FIR from the tracer's energy IR histogram
    (ops/reverb.impulse_response): each bin's energy becomes a sqrt
    -amplitude tap at its center arrival time, and the whole FIR is
    normalized to unit energy (sum h^2 = 1, guarding empty IRs) so the
    wet level is controlled solely by the settings gain."""
    n = reverb_ir.shape[0]
    dev = reverb_ir.device
    width = ir_max_distance / SPEED_OF_SOUND / n
    times = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * width
    idx = torch.clamp(torch.round(times * sample_rate).to(torch.int64),
                      0, length - 1)
    amp = torch.sqrt(torch.clamp(reverb_ir.to(torch.float32), min=0.0))
    h = torch.zeros((length,), device=dev).index_add_(0, idx, amp)
    norm = torch.sqrt(torch.sum(h * h))
    return h / torch.clamp(norm, min=1e-12)


def convolve_tail(x: Tensor, h: Tensor, tail: Tensor):
    """Overlap-add FFT convolution of one stereo buffer with the IR FIR.

    x: [N, 2]; h: [L]; tail: [L-1, 2] carry from previous buffers.
    Returns (wet [N, 2], new_tail [L-1, 2]). Per-frame IR updates
    crossfade naturally: the carried tail was produced by the previous
    frame's FIR and decays out while new input convolves with the new
    one.
    """
    N = x.shape[0]
    L = h.shape[0]
    M = N + L - 1
    nfft = 1 << (M - 1).bit_length()
    X = torch.fft.rfft(x, n=nfft, dim=0)
    H = torch.fft.rfft(h, n=nfft)[:, None]
    y = torch.fft.irfft(X * H, n=nfft, dim=0)[:M]
    y = torch.cat([y[:L - 1] + tail, y[L - 1:]])
    return y[:N], y[N:]


def _alpha_lp(cutoff, sample_rate):
    rc = 1.0 / (cutoff * TWO_PI)
    dt = 1.0 / sample_rate
    return dt / (rc + dt)


def _alpha_hp(cutoff, sample_rate):
    rc = 1.0 / (cutoff * TWO_PI)
    dt = 1.0 / sample_rate
    return rc / (rc + dt)


def spatialize(buffer: Tensor, state: DSPState,
               settings: SpatializerSettings, rt: TargetSettings,
               target_index, local_dir: Tensor, distance: Tensor,
               sample_rate: float, volume_multiplier: float = 1.0,
               reverb_ir: Tensor | None = None, device="cuda"):
    """Process one stereo buffer [N, 2] for one audio target on
    ``device`` (every tensor input must lie there).

    rt: TargetSettings from the tracer (muffle per target, reverb global).
    local_dir: [3] listener-local unit direction to the source.
    reverb_ir: optional [n_bins] impulse-response histogram from the
    tracer (TraceResult.reverb_ir); with ``settings.render_reverb_tail``
    and a tail-carrying state (DSPState.zero(tail_len=...)), an audible
    convolution tail is mixed in after the binaural stage.
    Returns (out [N, 2], new_state, reverb_dry_level scalar).
    """
    dev = resolve_device(device)
    check_device(dev, buffer=buffer, muffle=rt.muffle, local_dir=local_dir,
                 distance=distance, state=state.muffle_prev,
                 settings=settings.pan_strength)
    muffle_strength = rt.muffle[target_index]

    def saturate(v):
        return torch.clamp(v, 0.0, 1.0)

    # --- Muffle LP (MuffleDSP.cs) ---
    m = settings.muffle_curve.evaluate(muffle_strength)
    muffle_cutoff = settings.muffle_cutoff.max + (
        settings.muffle_cutoff.min - settings.muffle_cutoff.max) * m
    alpha_m = _alpha_lp(muffle_cutoff, sample_rate)
    filtered, new_muffle_prev = _one_pole_lp(buffer, state.muffle_prev,
                                             alpha_m)
    apply_muffle = muffle_strength > 0.0
    x = torch.where(apply_muffle, filtered, buffer)
    new_muffle_prev = torch.where(apply_muffle, new_muffle_prev,
                                  state.muffle_prev)

    # --- Reverb dry boost (ReverbDSP.cs) ---
    t = settings.reverb_volume_curve.evaluate(rt.reverb_volume)
    x = x * settings.reverb_dry_boost.lerp(t)

    # --- Binaural (BinauralDSP.cs) ---
    azimuth = torch.atan2(local_dir[0], local_dir[2])
    pan_strength = settings.pan_strength
    if settings.distance_based_panning:
        pan_strength = pan_strength * saturate(
            distance / settings.max_pan_distance)
    pan = torch.sin(azimuth) * pan_strength
    left_gain = torch.sqrt(0.5 * (1.0 - pan))
    right_gain = torch.sqrt(0.5 * (1.0 + pan))

    front = torch.clamp(torch.cos(azimuth), min=0.0)
    rear_floor = 1.0 - settings.rear_attenuation_strength
    rear = rear_floor + (1.0 - rear_floor) * front
    if settings.distance_based_rear_attenuation:
        dist_factor = saturate(
            1.0 - distance / settings.max_rear_attenuation_distance)
        rear = torch.minimum(torch.maximum(rear * dist_factor, rear_floor),
                             torch.ones_like(rear))

    y = local_dir[1]
    below = y <= 0.0
    elev_vol = torch.where(
        below,
        1.0 + (settings.low_pass_volume - 1.0) * saturate(-y),
        1.0 + (settings.high_pass_volume - 1.0) * saturate(y))

    gains = torch.stack([left_gain, right_gain]) * rear * elev_vol
    x = x * gains[None, :]

    dist_elev = saturate(distance / settings.max_elevation_effect_distance)
    lp_cutoff = settings.low_pass_cutoff.lerp(saturate(-y)) * (
        1.0 - 0.5 * dist_elev)
    hp_cutoff = settings.high_pass_cutoff.lerp(saturate(y)) * (
        1.0 + 0.5 * dist_elev)

    lp_out, lp_prev = _one_pole_lp(x, state.lp_prev,
                                   _alpha_lp(lp_cutoff, sample_rate))
    hp_out, hp_prev_out, hp_prev_in = _one_pole_hp(
        x, state.hp_prev_out, state.hp_prev_in,
        _alpha_hp(hp_cutoff, sample_rate))

    x = torch.where(below, lp_out, hp_out)
    new_state = DSPState(
        muffle_prev=new_muffle_prev,
        lp_prev=torch.where(below, lp_prev, state.lp_prev),
        hp_prev_out=torch.where(below, state.hp_prev_out, hp_prev_out),
        hp_prev_in=torch.where(below, state.hp_prev_in, hp_prev_in),
        # Carry the tail even when the tail stage does not run this call
        # (e.g. no IR harvested yet): dropping it would truncate ringing
        # audio and disable the stage from then on.
        reverb_tail=state.reverb_tail,
    )

    # --- Final volume (AudioSpatializer.cs:79-86) ---
    x = x * volume_multiplier

    # --- IR-driven reverb tail ---
    if (settings.render_reverb_tail and reverb_ir is not None
            and state.reverb_tail is not None):
        L = state.reverb_tail.shape[0] + 1
        h = ir_to_fir(reverb_ir, settings.reverb_ir_max_distance,
                      sample_rate, L)
        wet_gain = settings.reverb_wet_level.lerp(
            settings.reverb_strength_curve.evaluate(rt.reverb_strength))
        # Gain is folded into the FIR so the carried tail is already
        # scaled (adding it raw next frame would double-apply the gain).
        wet, new_tail = convolve_tail(x, wet_gain * h, state.reverb_tail)
        x = x + wet
        new_state = dataclasses.replace(new_state, reverb_tail=new_tail)

    # Unity AudioReverbFilter dryLevel mapping (AudioSpatializer.cs:58).
    dry_level = settings.reverb_dry_level.lerp(rt.reverb_strength)
    return x, new_state, dry_level


def make_spatialize(settings: SpatializerSettings, sample_rate: float,
                    volume_multiplier: float = 1.0, device="cuda"):
    """``step(buffer, state, rt, target_index, local_dir, distance,
    reverb_ir=None) -> (out, new_state, dry_level)``: ``spatialize`` with
    the settings and the host values closed over, on ``device``. On the
    card ``step`` is a ``SpatializeGraph`` (one captured CUDA graph a
    buffer from the second call of a key on); on the CPU ``spatialize``
    itself."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return SpatializeGraph(settings, sample_rate, volume_multiplier,
                               device=dev)

    def step(buffer, state, rt, target_index, local_dir, distance,
             reverb_ir=None):
        return spatialize(buffer, state, settings, rt, target_index,
                          local_dir, distance, sample_rate,
                          volume_multiplier, reverb_ir, device=dev)

    return step


class SpatializeGraph(CapturedCall):
    """``step(buffer, state, rt, target_index, local_dir, distance,
    reverb_ir=None) -> (out, new_state, dry_level)`` of ``spatialize``,
    replayed from one captured CUDA graph from the second call of a key
    on (``models/frame_graph.py::CapturedCall``).

    Every tensor input is copied into a static buffer; ``target_index``
    too, as a device integer, so every target of a source set shares one
    graph, as it shares one compiled program in JAX. ``settings`` (a
    public attribute) is read by identity: the graph reads its tensors
    where they are. The outputs are copied out of the graph's memory:
    ``out``, a fresh ``DSPState`` and ``dry_level``; the state passed in
    is never written.

    The key holds the host values: ``sample_rate``,
    ``volume_multiplier``, the settings' booleans and the identity of
    each of their tensors, whether ``reverb_ir`` and the state's
    ``reverb_tail`` are None, and the inputs' shapes and dtypes. A new
    key warms up and captures again. On the CPU the warm-up and the
    replays run the chain on the static buffers. Counters and timings as
    ``CapturedCall``'s."""

    def __init__(self, settings: SpatializerSettings, sample_rate: float,
                 volume_multiplier: float = 1.0, device="cuda"):
        self.settings = settings
        self.sample_rate = sample_rate
        self.volume_multiplier = volume_multiplier
        self._inputs = self._io = self._index = self._settings = None
        super().__init__(device)

    @torch.no_grad()
    def __call__(self, buffer: Tensor, state: DSPState, rt: TargetSettings,
                 target_index, local_dir: Tensor, distance: Tensor,
                 reverb_ir: Tensor | None = None):
        check_device(self.device, buffer=buffer, muffle=rt.muffle,
                     local_dir=local_dir, distance=distance,
                     state=state.muffle_prev,
                     settings=self.settings.pan_strength)
        inputs = (buffer, state, rt, local_dir, distance, reverb_ir)
        io = tuple(None if x is None else tuple(
            _describe(t) for t in tensors_of(x)) for x in inputs)
        if io != self._io:
            self._inputs = [map_tensors(torch.clone, x) for x in inputs]
            self._index = torch.zeros(1, dtype=torch.int64,
                                      device=self.device)
            self._io = io
        else:
            for mine, theirs in zip(self._inputs, inputs):
                for a, b in zip(tensors_of(mine), tensors_of(theirs)):
                    a.copy_(b)
        if isinstance(target_index, Tensor):
            self._index.copy_(target_index.reshape(1))
        else:  # a fill, not a copy of host memory
            self._index.fill_(int(target_index))
        st = self.settings
        self._set_key((self.sample_rate, self.volume_multiplier,
                       tuple(getattr(st, f.name) for f in
                             dataclasses.fields(st)
                             if isinstance(getattr(st, f.name), bool)),
                       tuple(id(t) for t in tensors_of(st)), io))
        # The settings the key names, held so no new tensor takes the
        # identity of one.
        self._settings = st
        return self._run(self._chain, _copy_out)

    def _chain(self):
        buffer, state, rt, local_dir, distance, reverb_ir = self._inputs
        # The target's muffle picked on the device (a host index would
        # be baked into the graph): the chain then reads target 0 of a
        # one-target settings.
        rt = dataclasses.replace(rt, muffle=rt.muffle.index_select(
            0, self._index))
        return spatialize(buffer, state, self._settings, rt, 0, local_dir,
                          distance, self.sample_rate, self.volume_multiplier,
                          reverb_ir, device=self.device)
