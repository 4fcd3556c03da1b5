"""Dense SE(3) attend (kernel B): wrapper of csrc/se3_attend.cu, its plain
PyTorch version, and the weight stacking both read.

Port of rosettafold_tpu/ops/pallas/se3_attend.py, forward and dense layout
only. The kernel takes the natural layouts of that file's `xla_reference`:
feat (B, J, S, ed); basis '{di},{do}' -> (B, J, S, 2do+1, 2di+1, nf);
h {0: (B, L, m0, 1), 1: (B, L, m1, 3)} with S == L; mask (B, J, S) bool;
qh (B, J, H*ck). Returns {d: (B, J, m_v, 2d+1)}: the GMABSE3 output. float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from . import build

launches = 0  # kernel launches made by this process

MID = 32
MAX_PAIRS = 8


def _ceil_to(x, m):
    return -(-x // m) * m


class PairSpec(NamedTuple):
    branch: str  # 'v' | 'k'
    di: int
    do: int
    mi: int
    mo: int
    nf: int
    w3_off: int   # row offset into the stacked (permuted) fc3 weights
    w3_rows: int  # mo * nf * mi, before padding
    w3_pad: int   # rows padded to a multiple of 8


class Meta(NamedTuple):
    ed: int                               # edge feature dim (edge_dim + 1)
    pairs: Tuple[PairSpec, ...]           # v pairs then k pairs, (di, do) sorted
    f_in: Tuple[Tuple[int, int], ...]     # ((degree, mult), ...)
    f_value: Tuple[Tuple[int, int], ...]  # v output fiber
    f_key: Tuple[Tuple[int, int], ...]    # k output fiber
    n_heads: int


def build_meta(f_in_dict: Dict[int, int], f_value_dict: Dict[int, int],
               f_key_dict: Dict[int, int], n_heads: int, edge_dim: int) -> Meta:
    pairs: List[PairSpec] = []
    off = 0
    for branch, fiber in (("v", f_value_dict), ("k", f_key_dict)):
        for do in sorted(fiber):
            for di in sorted(f_in_dict):
                mi, mo = f_in_dict[di], fiber[do]
                nf = 2 * min(di, do) + 1
                rows = mo * nf * mi
                pad = _ceil_to(rows, 8)
                pairs.append(PairSpec(branch, di, do, mi, mo, nf, off, rows, pad))
                off += pad
    return Meta(ed=edge_dim + 1, pairs=tuple(pairs),
                f_in=tuple(sorted(f_in_dict.items())),
                f_value=tuple(sorted(f_value_dict.items())),
                f_key=tuple(sorted(f_key_dict.items())), n_heads=n_heads)


def stack_weights(v_mod, k_mod, meta: Meta):
    """Stack the per-pair RadialFunc params of the v/k GConvSE3Partial modules
    (`pc_{di}_{do}.rp.{fc1,ln1,fc2,ln2,fc3}`) into the kernel's operands, in
    the JAX function's layout: w1t (32P, ed), misc (32P, 6), w2t (32P, 32),
    w3t (NW3, 32), w3b (NW3, 1). fc3 rows are permuted from the (o, c, f)
    flattening to (o, f, c) and padded with zero rows to multiples of 8."""
    w1, w2, m6, w3, b3 = [], [], [], [], []
    for p in meta.pairs:
        rp = getattr(v_mod if p.branch == "v" else k_mod, f"pc_{p.di}_{p.do}").rp
        w1.append(rp.fc1.weight)
        w2.append(rp.fc2.weight)
        m6.append(torch.stack([rp.fc1.bias, rp.ln1.weight, rp.ln1.bias,
                               rp.fc2.bias, rp.ln2.weight, rp.ln2.bias], dim=-1))
        # row r = o*nf*mi + f*mi + c  <-  original row (o*mi + c)*nf + f; built
        # on the weights' device (a host-made index would cost a copy + sync)
        o, f, c = torch.meshgrid(*(torch.arange(n, device=rp.fc3.weight.device)
                                   for n in (p.mo, p.nf, p.mi)), indexing="ij")
        perm = ((o * p.mi + c) * p.nf + f).reshape(-1)
        pad = p.w3_pad - p.w3_rows
        w3.append(torch.cat([rp.fc3.weight[perm], rp.fc3.weight.new_zeros(pad, MID)]))
        b3.append(torch.cat([rp.fc3.bias[perm], rp.fc3.bias.new_zeros(pad)]))
    return (torch.cat(w1).float(), torch.cat(m6).float(), torch.cat(w2).float(),
            torch.cat(w3).float(), torch.cat(b3)[:, None].float())


def se3_attend_plain(feat, basis, h, mask, qh, stacked, meta: Meta):
    """The kernel's math in plain PyTorch (port of `xla_reference`, dense)."""
    w1t, misc, w2t, w3t, w3b = stacked
    feat = feat.float()

    def ln(x, scale, bias):
        mu = x.mean(-1, keepdim=True)
        var = (x * x).mean(-1, keepdim=True) - mu * mu
        return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias

    msg = {"v": {}, "k": {}}
    for pidx, p in enumerate(meta.pairs):
        r0 = MID * pidx
        a = feat @ w1t[r0:r0 + MID].T + misc[r0:r0 + MID, 0]
        a = torch.relu(ln(a, misc[r0:r0 + MID, 1], misc[r0:r0 + MID, 2]))
        a = a @ w2t[r0:r0 + MID].T + misc[r0:r0 + MID, 3]
        a = torch.relu(ln(a, misc[r0:r0 + MID, 4], misc[r0:r0 + MID, 5]))
        rt = a @ w3t[p.w3_off:p.w3_off + p.w3_rows].T + w3b[p.w3_off:p.w3_off + p.w3_rows, 0]
        R = rt.reshape(*rt.shape[:-1], p.mo, p.nf, p.mi)  # permuted (o, f, c)
        t = torch.einsum("bjimnf,bicn->bjimfc", basis[f"{p.di},{p.do}"].float(),
                         h[p.di].float())
        contrib = torch.einsum("bjsofc,bjsmfc->bjsom", R, t)
        prev = msg[p.branch].get(p.do)
        msg[p.branch][p.do] = contrib if prev is None else prev + contrib

    H = meta.n_heads
    kh = torch.cat([msg["k"][d].reshape(*msg["k"][d].shape[:3], H, (mk // H) * (2 * d + 1))
                    for d, mk in meta.f_key], dim=-1)          # (B, J, S, H, ck)
    n_key = sum(m * (2 * d + 1) for d, m in meta.f_key)
    qr = qh.float().reshape(*qh.shape[:2], H, kh.shape[-1])    # (B, J, H, ck)
    e = torch.einsum("bjshc,bjhc->bjsh", kh, qr) / float(np.sqrt(n_key))
    m = mask[..., None]
    e = torch.where(m, e, torch.full_like(e, -1e9))
    att = torch.where(m, torch.softmax(e, dim=2), torch.zeros_like(e))
    z = {}
    for d, mv in meta.f_value:
        nd = 2 * d + 1
        vd = msg["v"][d].reshape(*msg["v"][d].shape[:3], H, mv // H, nd)
        agg = torch.einsum("bjsh,bjshcm->bjhcm", att, vd)
        z[d] = agg.reshape(*agg.shape[:2], mv, nd)
    return z


class _PairDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in
                ("branch", "di", "dout", "mi", "mo", "nf", "w3_off", "msg_off")]


class _KMeta(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("npairs", "ed", "H", "nv", "nk", "ck")]
                + [(n, ctypes.c_int * 2) for n in
                   ("m_in", "mk", "k_off", "hoff", "mv", "v_off")]
                + [("inv_sqrt", ctypes.c_float), ("p", _PairDesc * MAX_PAIRS)])


def _fiber_offsets(fiber):
    offs, mult, off = [0, 0], [0, 0], 0
    for d, m in fiber:
        offs[d], mult[d] = off, m
        off += m * (2 * d + 1)
    return offs, mult, off


def _kernel_meta(meta: Meta) -> _KMeta:
    H = meta.n_heads
    v_off, mv, nv = _fiber_offsets(meta.f_value)
    k_off, mk, nk = _fiber_offsets(meta.f_key)
    hoff, ck = [0, 0], 0
    for d, m in meta.f_key:
        hoff[d] = ck
        ck += (m // H) * (2 * d + 1)
    m_in = [0, 0]
    for d, m in meta.f_in:
        m_in[d] = m
    km = _KMeta(npairs=len(meta.pairs), ed=meta.ed, H=H, nv=nv, nk=nk, ck=ck,
                inv_sqrt=1.0 / math.sqrt(nk))
    for name, val in (("m_in", m_in), ("mk", mk), ("k_off", k_off), ("hoff", hoff),
                      ("mv", mv), ("v_off", v_off)):
        getattr(km, name)[:] = val
    for i, p in enumerate(meta.pairs):
        off = (v_off if p.branch == "v" else k_off)[p.do]
        km.p[i] = _PairDesc(0 if p.branch == "v" else 1, p.di, p.do, p.mi, p.mo, p.nf,
                            p.w3_off, off)
    return km


def _check(feat, basis, h, mask, qh, stacked, meta: Meta):
    if tuple(d for d, _ in meta.f_in) != (0, 1):
        raise ValueError(f"kernel needs input degrees (0, 1): {meta.f_in}")
    for fib in (meta.f_value, meta.f_key):
        if not {d for d, _ in fib} <= {0, 1}:
            raise ValueError(f"kernel handles degrees 0 and 1 only: {fib}")
        if any(m % meta.n_heads for _, m in fib):
            raise ValueError(f"multiplicities {fib} not divisible by {meta.n_heads} heads")
    B, J, S = mask.shape
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool: {mask.dtype}")
    if feat.shape != (B, J, S, meta.ed):
        raise ValueError(f"feat {tuple(feat.shape)} != {(B, J, S, meta.ed)}")
    for d, m in meta.f_in:
        if h[d].shape != (B, S, m, 2 * d + 1):
            raise ValueError(f"dense layout needs h[{d}] (B, S=L, {m}, {2 * d + 1}): "
                             f"{tuple(h[d].shape)}")
    for di in (0, 1):
        for do in (0, 1):
            shape = (B, J, S, 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1)
            if basis[f"{di},{do}"].shape != shape:
                raise ValueError(f"basis {di},{do}: {tuple(basis[f'{di},{do}'].shape)}")
    tensors = [feat, qh, *h.values(), *basis.values(), *stacked]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("SE(3) attend runs in float32")
    if any(t.device != mask.device for t in tensors):
        raise ValueError("all inputs must be on one device")


def _launch(feat, basis, h, mask, qh, stacked, meta: Meta):
    global launches
    B, J, S = mask.shape
    if len(meta.pairs) > MAX_PAIRS:
        raise ValueError(f"{len(meta.pairs)} degree pairs > {MAX_PAIRS}")
    w1t, misc, w2t, w3t, w3b = stacked
    args = [feat, basis["0,0"], basis["0,1"], basis["1,0"], basis["1,1"], h[0], h[1],
            mask, qh, w1t.t().contiguous(), misc, w2t, w3t, w3b]
    if not all(t.is_contiguous() for t in args):
        raise ValueError("SE(3) attend kernel needs contiguous inputs")
    km = _kernel_meta(meta)
    lib = build.load("se3_attend")
    lib.se3_attend_smem_bytes.restype = ctypes.c_size_t
    lib.se3_attend_smem_bytes.argtypes = [ctypes.c_int] * 5
    smem = lib.se3_attend_smem_bytes(S, km.nv, km.nk, km.H, km.ck)
    if smem > 227 * 1024:
        raise ValueError(f"S={S} needs {smem} bytes of shared memory (> 227 KB)")
    out = torch.empty((B, J, km.nv), dtype=torch.float32, device=feat.device)
    if B * J:
        fn = lib.se3_attend_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(_KMeta), ctypes.c_void_p])
        rc = fn(*[build.ptr(t) for t in args], build.ptr(out), B, J, S, S,
                ctypes.byref(km), build.stream_of(feat))
        build.check(lib, rc, "se3_attend_fwd")
        launches += 1
    z, col = {}, 0
    for d, mv in meta.f_value:
        nd = 2 * d + 1
        z[d] = out[:, :, col:col + mv * nd].reshape(B, J, mv, nd)
        col += mv * nd
    return z


def gse3_attend(feat, basis, h, mask, qh, stacked, meta: Meta):
    """Fused V/K partial convolutions + equivariant attention of one GSE3Res
    layer: the kernel on CUDA tensors, the plain version on CPU ones."""
    _check(feat, basis, h, mask, qh, stacked, meta)
    if mask.device.type == "cpu":
        return se3_attend_plain(feat, basis, h, mask, qh, stacked, meta)
    if mask.device.type == "cuda":
        return _launch(feat, basis, h, mask, qh, stacked, meta)
    raise ValueError(f"unsupported device {mask.device}")
