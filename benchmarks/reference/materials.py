"""Plain PyTorch reference of one materials training step: the loss and its
gradients in the 9 material tensors.

The program's differentiable loudness model (the gradient workload of
BASELINE.json configs[3]), written from its stated equations and not from
its code. A ray keeps its hard trajectory: the closest hit, the echo and
muffle visibility and the ray's death are discrete choices, held constant
under differentiation, and a continuous energy weights what it adds:

- energy: e_0 = 1 and, at a live hit k, e_{k+1} = e_k (1 - absorption of
  the primitive hit);
- muffle[t] = sum over rays r and hits k of e_k where the muffle ray from
  hit k to target t is clear, over R H;
- reverb energy = sum over r, k of e_k x echo_k over R H
  max_reverb_distance, where echo_k = |listener - p_k| x the echo of the
  primitive hit when the echo ray back to the listener is clear, else 0;
- permeation[t] = sum over rays with a first hit of (strength -
  chord(r, t) / R), over R, times the permeation effectiveness, where
  chord(r, t) is the sum over the primitives not owned by t of the chord
  length along the unbounded ray from the first hit toward target t times
  the primitive's density: linear in density;
- impulse response: each nonzero echo_k with weight e_k splatted linearly
  onto the two bins around echo_k x bins / ir_max_distance (beyond the
  window, the last bin), over R;
- loss: the mean over targets of the squared muffle gap, plus that of the
  squared permeation gap, plus the squared reverb energy gap, plus the
  mean over bins of the squared impulse response gap, each against the
  step's target map.

The ray life drains by each hit distance and by max_ray_life x the
absorption hit, with no gradient: it only decides which rays go on.

Departures from the frame reference (``frame.py``, the upstream Burst
semantics), each the model's own: muffle and echoes are weighted by the
ray's energy instead of counted; permeation sums every ray with a first
hit (no accumulation batches, no overwrite quirk) and needs no target
within the muffle distance; the impulse response weights each echo by its
energy and divides by R; nothing is saturated to [0, 1]. The geometry is
``frame.py``'s: its closest hit (strict ``<`` scan, spheres, AABBs, OBBs),
occlusion (a set skips its target's primitives), slab and sphere tests,
reflection and Fibonacci directions.

Every output is a sum over rays, so the step runs in two passes over
blocks of rays, in float32 (matrix products without TF32):

1. each block is traced once without gradients; it keeps what the hard
   trajectory fixes (per hit the ray, the primitive, the echo distance,
   the echo and muffle visibility) and, per target, the sum over its
   first-hitting rays of each primitive's chord length (the permeation's
   coefficient of each density), and adds the block's sums. From the
   sums, the loss and its gradient in the sums (dL/dsums);
2. each block's sums are made again from its record and the 9 material
   tensors under autograd, and <dL/dsums, block sums> is differentiated
   into them. The sums are linear in the block's terms, so the
   gradients are exact.

dL/dsums is the map's gap to its target times constants, so a ray that
resolves otherwise in a program (a hit, an echo or a muffle ray decided
by float32 rounding) moves every gradient through the map. ``at`` takes
dL/dsums at a given map as well (the program's own, judged on its own),
which leaves in the gradients only what the rays add directly. ``adam``
is the plain Adam update a step's gradients make.

It imports nothing of the program and takes nothing the program made but
the step's inputs: the benchmark's own ``layout`` for the geometry, the
9 material tensors the step starts from, the listener, the directions
and the target map.
"""

from __future__ import annotations

import torch

from . import frame

TYPES = ("sph", "aabb", "obb")
FIELDS = ("absorption", "density", "echo")
# Rays traced together through every bounce (the grids inside are blocked
# again by their primitive count, frame.GRID_ELEMS).
RAY_BLOCK = 1 << 16


def leaf_names() -> list[str]:
    """The 9 material tensors' names, type-major: sph.absorption, ...,
    obb.echo."""
    return [f"{k}.{f}" for k in TYPES for f in FIELDS]


def _columns(leaves):
    """(absorption, density, echo) over every primitive, in the scan's
    order, from the 9 tensors (type-major)."""
    return [torch.cat([leaves[3 * k + f] for k in range(3)])
            for f in range(3)]


def chords(sc: frame.Scene, o, d, skip: int):
    """[n, P] chord length through each primitive along the unbounded
    rays (o, d), |d| = 1, zero where the ray misses it, it lies behind
    the ray, or ``skip`` owns it."""
    own = [sc.owners(k) != skip for k in range(3)]
    oc = o[:, None, :] - sc.sc
    b = frame._dot(oc, d[:, None, :])
    c = frame._dot(oc, oc) - sc.sr * sc.sr
    disc = b * b - c
    s = torch.sqrt(torch.where(disc > 0.0, disc, 0.0))
    t_in, t_out = -b - s, -b + s
    ch = torch.clamp(t_out - torch.clamp(t_in, min=0.0), min=0.0)
    out = [torch.where((disc >= 0.0) & (t_out >= 0.0) & own[0], ch, 0.0)]

    def box(t_near, t_far, mask):
        ch = torch.clamp(t_far - torch.clamp(t_near, min=0.0), min=0.0)
        return torch.where((t_near <= t_far) & (t_far >= 0.0) & mask, ch,
                           0.0)

    org = frame._Origins(sc, o)
    out.append(box(*frame._slab(org.a_lo, org.a_hi,
                                1.0 / frame._nudge(d)[:, None]), own[1]))
    ld = (d @ sc.rot_t).view(d.shape[0], -1, 3)
    out.append(box(*frame._slab(org.b_lo, org.b_hi, 1.0 / frame._nudge(ld)),
                   own[2]))
    return torch.cat(out, dim=1)


def _trace_block(sc: frame.Scene, origin, d0, cfg: dict, absorption):
    """Pass one's trace of one block of rays (directions d0 [n, 3]): the
    record of its hits (per bounce the live hits' rays, primitives, echo
    distances, echo visibility and muffle visibility [m, T]) and its first
    hits' offset points."""
    n = d0.shape[0]
    H = cfg["max_bounces"] + 1
    T = sc.targets.shape[0]
    eps, life0 = cfg["epsilon"], cfg["max_ray_life"]
    far = cfg["max_muffle_hit_distance"]
    dev = d0.device
    o = origin.expand(n, 3).clone()
    d = d0.clone()
    life = torch.full((n,), life0, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    hits, first = [], None
    for step in range(H):
        a_idx = alive.nonzero().squeeze(1)
        if a_idx.numel() == 0:
            break
        t_a, w_a = frame.closest_hit(sc, o[a_idx], d[a_idx])
        hit = torch.isfinite(t_a)
        idx, w, t = a_idx[hit], w_a[hit], t_a[hit]
        if step == 0:
            first = o[idx] + d[idx] * t[:, None] - d[idx] * eps
        if idx.numel() == 0:
            break
        oi, di = o[idx], d[idx]
        p = oi + di * t[:, None]
        lf = life[idx] - t
        off = p - di * eps
        dist_echo = frame._norm(origin - p)
        to_o = origin - off
        sets = [(to_o / frame._norm(to_o)[:, None], dist_echo, frame.NO_SKIP,
                 torch.ones_like(dist_echo, dtype=torch.bool))]
        for k in range(T):
            to_t = sc.targets[k] - off
            dist = frame._norm(to_t)
            sets.append((to_t / dist[:, None], dist, k, dist < far))
        occ = frame.occluded(sc, off, sets)
        vis = torch.stack([~occ[:, k] & sets[k][3]
                           for k in range(1 + T)], dim=-1)
        hits.append((idx, w, dist_echo, vis[:, 0], vis[:, 1:]))
        go = (lf > 0.0) & (step + 1 < H)
        nrm = frame._normal(sc, p, w)
        d_new = di - 2.0 * frame._dot(di, nrm)[:, None] * nrm
        lf_new = lf - life0 * absorption[w]
        o[idx] = torch.where(go[:, None], p + d_new * eps, p)
        d[idx] = torch.where(go[:, None], d_new, di)
        life[idx] = torch.where(go, lf_new, lf)
        alive = torch.zeros_like(alive)
        alive[idx] = go & (lf_new >= 0.0)
    if first is None:
        first = d0.new_zeros((0, 3))
    return hits, first


def _chord_sums(sc: frame.Scene, first, T: int):
    """[T, P]: per target, the sum over the first hits of each primitive's
    chord length toward it."""
    out = first.new_zeros((T, sc.total))
    for b in frame._blocks(first.shape[0], sc.total):
        off = first[b]
        for k in range(T):
            to_t = sc.targets[k] - off
            out[k] += chords(sc, off, to_t / frame._norm(to_t)[:, None],
                             k).sum(0)
    return out


def _block_sums(rec: dict, cols, cfg: dict, T: int):
    """One block's sums from its record and the material columns
    (absorption, density, echo over every primitive): muffle [T], echo
    energy [], impulse response [bins], the first hits [] and the chord
    losses [T] of the permeation; in the autograd graph of the
    columns."""
    absorption, density, echo = cols
    n, nb = rec["n"], cfg["num_reverb_bins"]
    energy = absorption.new_ones((n,))
    muffle = absorption.new_zeros((T,))
    values, weights = [], []
    for idx, w, dist_echo, seen, mvis in rec["hits"]:
        e = energy[idx]
        muffle = muffle + torch.where(mvis, e[:, None], 0.0).sum(0)
        values.append(torch.where(seen, dist_echo * echo[w], 0.0))
        weights.append(torch.where(seen, e, 0.0))
        factor = absorption.new_ones((n,)).index_put(
            (idx,), 1.0 - absorption[w])
        energy = energy * factor
    v = torch.cat(values) if values else absorption.new_zeros((0,))
    wt = torch.cat(weights) if weights else absorption.new_zeros((0,))
    echo_sum = (v * wt).sum()
    ir = absorption.new_zeros((max(nb, 0),))
    if nb > 0:
        wt = torch.where(v > 0.0, wt, 0.0)
        pos = torch.clamp(v * (nb / cfg["ir_max_distance"]), 0.0, nb - 1.0)
        i0f = torch.floor(pos)
        frac = pos - i0f
        i0 = i0f.long()
        i1 = torch.clamp(i0 + 1, max=nb - 1)
        ir = ir.index_add(0, i0, wt * (1.0 - frac)).index_add(0, i1,
                                                               wt * frac)
    # The permeation's two parts apart (a float32 difference of the
    # first hits' strength and the small chord term would cancel).
    return dict(muffle=muffle, echo=echo_sum, ir=ir,
                first=absorption.new_tensor(float(rec["n_first"])),
                chord=rec["chords"] @ density)


def loudness(sums: dict, cfg: dict, R: int, H: int) -> dict:
    """The loudness map of the step's sums: muffle [T], permeation [T],
    reverb_energy [] and reverb_ir [bins] (when on)."""
    out = dict(
        muffle=sums["muffle"] / (R * H),
        permeation=((sums["first"] * cfg["permeation_strength_per_ray"]
                     - sums["chord"] / R) / R
                    * cfg["permeation_effectiveness"]),
        reverb_energy=sums["echo"] / (R * H * cfg["max_reverb_distance"]))
    if cfg["num_reverb_bins"] > 0:
        out["reverb_ir"] = sums["ir"] / R
    return out


def _mse(m: dict, target: dict):
    """The loss of a loudness map against the step's target map."""
    loss = (torch.mean((m["muffle"] - target["muffle"]) ** 2)
            + torch.mean((m["permeation"] - target["permeation"]) ** 2)
            + (m["reverb_energy"] - target["reverb_energy"]) ** 2)
    if "reverb_ir" in m:
        loss = loss + torch.mean((m["reverb_ir"] - target["reverb_ir"]) ** 2)
    return loss


def adam(before, grads, exp_avg, exp_avg_sq, steps, lr: float, betas,
         eps: float, dtype=torch.float64) -> list:
    """One Adam update (Kingma and Ba, with bias correction) of each
    tensor of ``before`` by its gradient, from its moments and its count
    of steps taken before, computed in ``dtype``: the tensors after it."""
    b1, b2 = betas
    out = []
    for p, g, m, v, n in zip(before, grads, exp_avg, exp_avg_sq, steps):
        p, g, m, v = (torch.as_tensor(x).to(dtype) for x in (p, g, m, v))
        t = float(n) + 1.0
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
        out.append(p - lr * m_hat / (torch.sqrt(v_hat) + eps))
    return out


def step(layout: dict, leaves, origin, target: dict, cfg: dict, device,
         directions=None, ray_block: int = RAY_BLOCK, at: dict | None = None,
         dtype=torch.float32) -> dict:
    """The loss and gradients of one materials step for the listener at
    ``origin`` [3]: ``leaves`` the 9 material tensors the step starts from
    (``leaf_names()``' order), ``target`` the step's target map (muffle
    [T], permeation [T], reverb_energy [], reverb_ir [bins]), ``cfg`` the
    trace settings by their ``TraceConfig`` names; the geometry is
    ``layout``'s, the directions default to the Fibonacci set. Returns
    ``loss`` (a float), ``grads`` (9 tensors), ``loudness`` (the map at
    the starting materials) and ``counts``: the rays with a first hit
    (``hitting``) and the live hits per bounce (``live``).

    ``at``: a loudness map (the program's own) at which the loss's
    gradient in the map is taken as well; ``grads_at`` are the 9
    gradients through this step's sums from there. The sums are linear in
    the map, so only the outer factor of the chain changes.

    ``dtype``: the precision of everything the gradient flows through
    (the materials, the record's distances and chord sums, every block's
    sums, their totals, the loss and the gradients; reductions as PyTorch
    makes them for that dtype). The hard trajectory is traced in float32
    on the float32 scene whatever it is. At float32 the totals are added
    in float64."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _step(layout, leaves, origin, target, cfg, device,
                     directions, ray_block, at, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def _step(layout, leaves, origin, target, cfg, device, directions,
          ray_block, at, dtype):
    sc = frame.Scene(layout, device)
    R, H = cfg["ray_count"], cfg["max_bounces"] + 1
    T = sc.targets.shape[0]
    wide = torch.float64 if dtype == torch.float32 else dtype
    origin = torch.as_tensor(origin, dtype=torch.float32).to(device)
    d_all = (frame.fibonacci_directions(R, device) if directions is None
             else directions.to(device=device, dtype=torch.float32))
    leaves = [torch.as_tensor(x).detach().to(device=device,
                                             dtype=torch.float32).clone()
              for x in leaves]
    tgt = {k: torch.as_tensor(v).detach().to(device=device, dtype=wide)
           for k, v in target.items() if v is not None}
    counts = dict(hitting=0, live=[0] * H)

    # Pass one: trace (float32), record, sum.
    records, totals = [], None
    with torch.no_grad():
        trail = _columns(leaves)[0]
        cols = _columns([x.to(dtype) for x in leaves])
        for start in range(0, R, ray_block):
            d0 = d_all[start:start + ray_block]
            hits, first = _trace_block(sc, origin, d0, cfg, trail)
            rec = dict(n=d0.shape[0], n_first=first.shape[0],
                       hits=[(i, w, de.to(dtype), s, m)
                             for i, w, de, s, m in hits],
                       chords=_chord_sums(sc, first, T).to(dtype))
            counts["hitting"] += first.shape[0]
            for k, h in enumerate(hits):
                counts["live"][k] += int(h[0].numel())
            sums = _block_sums(rec, cols, cfg, T)
            totals = ({k: v.to(wide) for k, v in sums.items()}
                      if totals is None else
                      {k: totals[k] + v.to(wide) for k, v in sums.items()})
            records.append(rec)

    # dL/dsums, at this step's own map and at ``at``.
    totals = {k: v.requires_grad_() for k, v in totals.items()}
    names = sorted(totals)
    m = loudness(totals, cfg, R, H)
    loss = _mse(m, tgt)
    outer = [torch.autograd.grad(loss, [totals[k] for k in names],
                                 retain_graph=at is not None)]
    if at is not None:
        m_at = {k: v + (torch.as_tensor(at[k]).to(v) - v).detach()
                for k, v in m.items()}
        outer.append(torch.autograd.grad(_mse(m_at, tgt),
                                         [totals[k] for k in names]))

    # Pass two: each block's <dL/dsums, sums> into the 9 tensors.
    grads = []
    for g in outer:
        mine = [x.to(dtype).clone().requires_grad_() for x in leaves]
        for rec in records:
            sums = _block_sums(rec, _columns(mine), cfg, T)
            dot = sum((gk * sums[k].to(wide)).sum()
                      for k, gk in zip(names, g))
            dot.backward()
        grads.append([x.grad.detach() if x.grad is not None
                      else torch.zeros_like(x) for x in mine])
    out = dict(loss=float(loss.detach()), grads=grads[0],
               loudness={k: v.detach() for k, v in m.items()},
               counts=counts)
    if at is not None:
        out["grads_at"] = grads[1]
    return out
