"""B9, the op-rate calibration kernel of the roofline tool.

``run_calibrate`` replaces the TPU kernel ``tools/roofline.py::calibrate.
kernel``: a counted chain of float32 operations per lane and per
"primitive" (``csrc/calibrate.cu``), whose marginal rate between 88 and
176 operations per primitive is the card's instruction-rate ceiling for the
production kernels' instruction stream. On a CPU tensor it runs
``calibrate_plain``, the same chain as tensor operations, which gives the
kernel's values bit for bit (``--fmad=false``).

``run_calibrate_bf16x2`` runs the same kind of chains in Hopper's packed
bfloat16 instructions (``csrc/calibrate.cu::calibrate_bf16x2_kernel``),
whose marginal rates bound the bfloat16 tier's kernels; on a CPU tensor
``calibrate_bf16x2_plain`` gives its bits.

``sass_loop_counts`` reads the built library back with ``cuobjdump`` and
counts the float32 instructions in each instance's loop body (the packed
ones in the packed instances' loops), which must equal the counted
operations. ``loop_bodies`` does the same for any
kernel of any library: per innermost loop, an opcode histogram and its
classes (float32, integer and predicate logic, MUFU, LDS, branches).
"""

from __future__ import annotations

import collections
import re
import subprocess

import torch

from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.cuda.kernels import (
    bf16x2_words,
    check_operands,
    on_cpu,
    stream_of,
)

Tensor = torch.Tensor

MIXES = ("fma4", "occl")
OPS_PER_ITER = (88, 176)
# Counted operations per round of each mix (the chains cycle in whole
# rounds, so a body counts (ops // unit) * unit).
UNIT = {"fma4": 8, "occl": 11}
FIELDS_W = 8  # csrc/calibrate.cu CAL_W: six fields, two pad


def field_table(fields) -> Tensor:
    """Six [prims] float32 fields as the kernel's [prims, 8] table."""
    tab = torch.stack([f.to(torch.float32) for f in fields], dim=1)
    return torch.nn.functional.pad(tab, (0, FIELDS_W - 6)).contiguous()


def _check(mix: str, ops_per_iter: int, fields) -> None:
    if mix not in MIXES or ops_per_iter not in OPS_PER_ITER:
        raise ValueError(f"mix {mix!r}, ops {ops_per_iter}: expected one of "
                         f"{MIXES} and one of {OPS_PER_ITER}")
    if len(fields) != 6:
        raise ValueError("calibration needs six fields")


def calibrate_plain(mix: str, ops_per_iter: int, x: Tensor, fields):
    """Plain version of B9: the counted chain of tools/roofline.py over
    the six fields, per element of x; returns v1 + v2 + v3 + v4, shaped
    as x."""
    _check(mix, ops_per_iter, fields)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    v0 = x.reshape(-1)
    v1, v2, v3, v4 = v0, v0 * f32(1.1), v0 * f32(0.9), v0 * f32(1.2)
    c1, c2, c3, c4 = f32(1e-7), f32(2e-7), f32(3e-7), f32(4e-7)
    k, tiny = f32(1e-3), f32(1e-9)
    for p in range(fields[0].shape[0]):
        f = [x_[p] for x_ in fields]
        if mix == "fma4":
            for q in range(ops_per_iter // 8):
                s = f[q % 6]
                v1 = v1 * s + c1
                v2 = v2 * s + c2
                v3 = v3 * s + c3
                v4 = v4 * s + c4
        else:
            for q in range(ops_per_iter // 11):
                s, t = f[q % 3], f[3 + q % 3]
                v1 = v1 * s + c1
                v2 = v2 + t * k
                v3 = torch.minimum(v3, v1)
                v4 = torch.maximum(v4, v2)
                v1 = torch.where(v3 > v4, v1, v2)
                v2 = torch.where(v2 < v3, v2 + tiny, v2)
    return (v1 + v2 + v3 + v4).reshape(x.shape)


def counted_ops(mix: str, ops_per_iter: int, lanes: int, prims: int) -> int:
    """Counted float32 operations of one calibration call."""
    return lanes * prims * (ops_per_iter // UNIT[mix]) * UNIT[mix]


def run_calibrate(mix: str, ops_per_iter: int, x: Tensor, fields):
    """B9: ``mix`` "fma4" or "occl", ``ops_per_iter`` 88 or 176, x any
    float32 tensor (one lane per element; the JAX tool's is (blocks * 8,
    512)), ``fields`` six [prims] float32 tensors. Returns v1 + v2 + v3 +
    v4 per lane, shaped as x."""
    if on_cpu(x):
        return calibrate_plain(mix, ops_per_iter, x, fields)
    _check(mix, ops_per_iter, fields)
    lib = build.load("calibrate")
    dev = x.device
    x = x.contiguous()
    tab = field_table(fields)
    check_operands(dev, x, tab)
    out = torch.empty_like(x)
    err = lib.calibrate(x.data_ptr(), x.numel(), tab.data_ptr(),
                        tab.shape[0], MIXES.index(mix), ops_per_iter,
                        out.data_ptr(), stream_of(dev))
    build.check("calibrate", err)
    if x.numel():
        run_calibrate.launches += 1
    return out


run_calibrate.launches = 0


# The packed bfloat16 chains: "addmul" (a mul.rn.bf16x2 and an
# add.rn.bf16x2 a step of four chains, 8 instructions a round),
# "minmax" (min / max.bf16x2, 4 a round), and "add" and "mul" (eight
# independent chains of add.rn.bf16x2 or mul.rn.bf16x2 alone, 8 a round),
# at 88 and 176 packed instructions per primitive; each instruction is two
# bfloat16 operations.
PACKED_MIXES = ("addmul", "minmax", "add", "mul")
PACKED_UNIT = {"addmul": 8, "minmax": 4, "add": 8, "mul": 8}


def _check_packed(mix: str, ops_per_iter: int, fields) -> None:
    if mix not in PACKED_MIXES or ops_per_iter not in OPS_PER_ITER:
        raise ValueError(f"mix {mix!r}, ops {ops_per_iter}: expected one of "
                         f"{PACKED_MIXES} and one of {OPS_PER_ITER}")
    if len(fields) != 6:
        raise ValueError("calibration needs six fields")


def _bf16(v: float, device) -> Tensor:
    """v rounded to bfloat16 as the kernel's cvt.rn.bf16x2.f32 rounds the
    float32 constant."""
    return torch.tensor(v, dtype=torch.float32,
                        device=device).to(torch.bfloat16)


def calibrate_bf16x2_plain(mix: str, ops_per_iter: int, x: Tensor, fields):
    """Plain version of the packed chains: x a bfloat16 tensor of an even
    number of values (two a lane), ``fields`` six [prims] tensors (rounded
    to bfloat16); returns v1 + v2 + v3 + v4 (+ v5 + v6 + v7 + v8 for
    "add" and "mul"), bfloat16, shaped as x."""
    _check_packed(mix, ops_per_iter, fields)
    dev = x.device
    v0 = x.reshape(-1)
    v = [v0] + [v0 * _bf16(k, dev)
                for k in (1.1, 0.9, 1.2, 1.3, 0.8, 1.05, 0.95)]
    c = [_bf16(k * 1e-3, dev) for k in (1, 2, 3, 4)]
    tabs = [f.to(torch.bfloat16) for f in fields]
    for p in range(tabs[0].shape[0]):
        f = [t[p] for t in tabs]
        if mix == "addmul":
            for q in range(ops_per_iter // 8):
                s = f[q % 6]
                v[:4] = [v[k] * s + c[k] for k in range(4)]
        elif mix == "minmax":
            for q in range(ops_per_iter // 4):
                s, t = f[q % 3], f[3 + q % 3]
                v[:4] = [torch.minimum(v[0], s), torch.maximum(v[1], s),
                         torch.minimum(v[2], t), torch.maximum(v[3], t)]
        else:
            for q in range(ops_per_iter // 8):
                s = f[q % 6]
                v = [vk + s if mix == "add" else vk * s for vk in v]
    out = v[0]
    for vk in v[1:8 if mix in ("add", "mul") else 4]:
        out = out + vk
    return out.reshape(x.shape)


def counted_packed_ops(mix: str, ops_per_iter: int, lanes: int,
                       prims: int) -> int:
    """bfloat16 operations of one packed calibration call: two per packed
    instruction, ``lanes`` words."""
    return 2 * lanes * prims * (ops_per_iter // PACKED_UNIT[mix]) * \
        PACKED_UNIT[mix]


def run_calibrate_bf16x2(mix: str, ops_per_iter: int, x: Tensor, fields):
    """The packed chains: ``mix`` one of PACKED_MIXES, ``ops_per_iter``
    88 or 176 packed instructions, x a bfloat16 tensor of an even number
    of values (one bf16x2 word a lane), ``fields`` six [prims] tensors.
    Returns ``calibrate_bf16x2_plain``'s sum, bfloat16, shaped as x."""
    if on_cpu(x):
        return calibrate_bf16x2_plain(mix, ops_per_iter, x, fields)
    _check_packed(mix, ops_per_iter, fields)
    if x.dtype != torch.bfloat16 or x.numel() % 2:
        raise ValueError("expected an even number of bfloat16 values")
    lib = build.load("calibrate")
    dev = x.device
    x = x.contiguous()
    words = torch.stack([bf16x2_words(f) for f in fields], dim=1)
    tab = torch.nn.functional.pad(words, (0, FIELDS_W - 6)).contiguous() \
        .view(torch.float32)
    check_operands(dev, tab)
    check_operands(dev, x, dtypes=(torch.bfloat16,))
    out = torch.empty_like(x)
    err = lib.calibrate_bf16x2(x.data_ptr(), x.numel() // 2, tab.data_ptr(),
                               tab.shape[0], PACKED_MIXES.index(mix),
                               ops_per_iter, out.data_ptr(), stream_of(dev))
    build.check("calibrate_bf16x2", err)
    if x.numel():
        run_calibrate_bf16x2.launches += 1
    return out


run_calibrate_bf16x2.launches = 0


# ---------------------------------------------------------------------------
# The loop bodies in the machine code
# ---------------------------------------------------------------------------

# Float32 arithmetic, compare and select instructions of a Hopper SASS
# listing (a select may come out as the integer SEL on float bits).
FP32_OPCODES = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSET", "FSEL",
                "SEL")
# The classes of a loop-body histogram; any other opcode (moves, global
# loads and stores, conversions, FCHK) counts as "other".
OPCODE_CLASSES = {
    "fp32": FP32_OPCODES,
    "int": ("ISETP", "IADD3", "IADD", "LOP3", "PLOP3", "IMAD", "IMNMX",
            "IABS", "SHF", "LEA", "P2R", "R2P", "VIADD", "PRMT", "FLO",
            "POPC"),
    "mufu": ("MUFU",),
    "lds": ("LDS",),
    "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "JMP", "BREAK",
               "WARPSYNC", "BAR", "VOTE", "VOTEU", "EXIT"),
}
# Hopper's packed 16-bit float instructions, each one operation on both
# halves of a bf16x2 word, but VHMNMX: the three-input min / max into
# which ptxas fuses two chained min.bf16x2 (or max.bf16x2), two
# operations a half. And the instructions that widen and pack halves.
PACKED_OPCODES = ("HADD2", "HMUL2", "HFMA2", "HMNMX2", "VHMNMX", "HSET2",
                  "HSETP2")
WIDEN_PACK_OPCODES = ("PRMT", "F2F", "F2FP")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function : (\S+)")
_TEMPLATE = re.compile(r"calibrate_kernelILi(\d)ELi(\d+)E")
_PACKED_TEMPLATE = re.compile(r"calibrate_bf16x2_kernelILi(\d)ELi(\d+)E")


def opcode_classes(ops: dict) -> dict:
    """{class: instructions} of an opcode histogram (OPCODE_CLASSES, then
    "other")."""
    out = {c: 0 for c in (*OPCODE_CLASSES, "other")}
    for op, n in ops.items():
        out[next((c for c, names in OPCODE_CLASSES.items() if op in names),
                 "other")] += n
    return out


def packed_classes(ops: dict) -> dict:
    """{"packed": PACKED_OPCODES' instructions, "VHMNMX": those of them
    that fuse two min / max, and each of WIDEN_PACK_OPCODES} of an opcode
    histogram."""
    out = dict(packed=sum(ops.get(op, 0) for op in PACKED_OPCODES),
               VHMNMX=ops.get("VHMNMX", 0))
    out.update({op: ops.get(op, 0) for op in WIDEN_PACK_OPCODES})
    return out


def loop_bodies(sass: str, pattern: str, counted=FP32_OPCODES) -> dict:
    """{function: [loop, ...]} for every function of a ``cuobjdump -sass``
    listing whose (mangled) name matches the regular expression
    ``pattern``. A loop is a backward branch and the instructions it
    spans; only the innermost ones (spanning no other loop) that hold
    an instruction of ``counted`` (float32 ones by default) are kept, in
    address order, each as dict(start, end, ops: opcode histogram,
    classes: ``opcode_classes`` of it). A loop unrolled by the compiler
    holds several iterations' bodies."""
    out = {}
    for chunk in re.split(r"(?=\s+Function : )", sass):
        m = _FUNC.search(chunk)
        if not m or not re.search(pattern, m.group(1)):
            continue
        insns, labels, pending = [], {}, []
        for line in chunk.splitlines():
            lm = _LABEL.match(line)
            if lm:
                pending.append(lm.group(1))
                continue
            im = _INSN.search(line)
            if im:
                addr = int(im.group(1), 16)
                for name in pending:
                    labels[name] = addr
                pending = []
                insns.append((addr, im.group(3), im.group(4)))
        spans = []
        for addr, op, args in insns:
            if not op.startswith("BRA"):
                continue
            tm = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", args)
            if not tm:
                continue
            target = labels.get(tm.group(1)) if tm.group(1) \
                else int(tm.group(2), 16)
            if target is not None and target < addr:
                spans.append((target, addr))
        loops = []
        for lo, hi in sorted(set(spans)):
            if any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in spans):
                continue
            ops = collections.Counter(op.split(".")[0] for a, op, _ in insns
                                      if lo <= a <= hi)
            classes = opcode_classes(ops)
            if any(ops.get(op) for op in counted):
                loops.append(dict(start=lo, end=hi, ops=dict(ops),
                                  classes=classes))
        out[m.group(1)] = loops
    return out


def loop_body_counts(sass: str) -> dict:
    """{(mix, ops_per_iter): (float32 instructions, opcode histogram)} of
    the primitive loop of each calibrate_kernel instance in a ``cuobjdump
    -sass`` listing: the innermost loop (the backward branch with the
    shortest span) that holds float32 instructions; the tile-staging
    loop holds none."""
    out = {}
    for name, loops in loop_bodies(sass, _TEMPLATE.pattern).items():
        if loops:
            t = _TEMPLATE.search(name)
            body = min(loops, key=lambda lp: lp["end"] - lp["start"])
            out[MIXES[int(t.group(1))], int(t.group(2))] = (
                body["classes"]["fp32"], body["ops"])
    return out


def packed_loop_counts(sass: str) -> dict:
    """{(mix, ops_per_iter): (packed operations, opcode histogram)} of
    the primitive loop of each calibrate_bf16x2_kernel instance, as
    ``loop_body_counts`` finds the float32 ones; a VHMNMX counts as the
    two min / max it fuses."""
    out = {}
    for name, loops in loop_bodies(sass, _PACKED_TEMPLATE.pattern,
                                   PACKED_OPCODES).items():
        if loops:
            t = _PACKED_TEMPLATE.search(name)
            body = min(loops, key=lambda lp: lp["end"] - lp["start"])
            c = packed_classes(body["ops"])
            out[PACKED_MIXES[int(t.group(1))], int(t.group(2))] = (
                c["packed"] + c["VHMNMX"], body["ops"])
    return out


def library_sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<name>.cu``."""
    build.load(name)
    return subprocess.run([build.find_cuda_tool("cuobjdump"), "-sass",
                           build.lib_path(name)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def sass_loop_counts() -> dict:
    """``loop_body_counts`` of the built calibration library."""
    return loop_body_counts(library_sass("calibrate"))
