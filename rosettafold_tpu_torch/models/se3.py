"""SE(3)-equivariant transformer on masked kNN neighborhoods (port of
rosettafold_tpu/models/se3.py: the dense, gather and scatter layouts).
float32 throughout.

Features are dicts {degree: (B, L, multiplicity, 2*degree+1)}. On the dense
and gather layouts edge tensors are dst-major: T[b, j, s] describes the edge
from source slot s into j, rel_pos[b, j, s] = x_j - x_src. Dense layout: slot
s is node s (S == L). Gather layout: src_idx (B, L, S) names each slot's
node, and the plain path gathers the node features per layer to
(B, L, S, m, 2d+1). With impl="pallas" each GSE3Res runs its V/K partial
convolutions and attention through kernel B (ops/cuda/se3_attend.py), which
reads the sources in place. Scatter layout: edge tensors are src-major,
T[b, i, s] describes the edge from i into dst_idx[b, i, s], rel_pos = x_dst -
x_i; the source feature is node i's own row, and the softmax and the sum
group the edges by destination through segment ops (`index_add_`,
`scatter_reduce_`). As in JAX, the scatter layout runs these plain ops even
under impl="pallas": kernel B is not launched there.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..ops import so3
from ..ops.cuda import se3_attend
from ..parallel import mesh
from .layers import Dense, LayerNorm

Features = Dict[int, torch.Tensor]


class Fiber:
    """Degree -> multiplicity structure descriptor."""

    def __init__(self, dictionary: Optional[Dict[int, int]] = None,
                 num_degrees: Optional[int] = None, num_channels: Optional[int] = None):
        if dictionary is None:
            dictionary = {d: num_channels for d in range(num_degrees)}
        self.dict = {int(k): int(v) for k, v in sorted(dictionary.items())}
        self.degrees = tuple(self.dict.keys())
        self.n_features = sum(m * (2 * d + 1) for d, m in self.dict.items())

    def __repr__(self):
        return f"Fiber({self.dict})"


def fiber2head(feats: Features, n_heads: int, fiber: Fiber) -> torch.Tensor:
    """Pack per-degree tensors (..., m, 2d+1) into (..., h, sum(m/h*(2d+1)))."""
    parts = []
    for d in fiber.degrees:
        v = feats[d]
        m = fiber.dict[d]
        parts.append(v.reshape(*v.shape[:-2], n_heads, (m // n_heads) * (2 * d + 1)))
    return torch.cat(parts, dim=-1)


class RadialFunc(nn.Module):
    """Radial profile MLP: (edge_dim+1) -> 32 -> 32 -> num_freq*in*out with
    LayerNorm + ReLU; output (..., out, in, num_freq)."""

    def __init__(self, num_freq: int, in_dim: int, out_dim: int, edge_dim: int = 0,
                 mid_dim: int = 32):
        super().__init__()
        self.num_freq, self.in_dim, self.out_dim = num_freq, in_dim, out_dim
        self.fc1 = Dense(edge_dim + 1, mid_dim)
        self.ln1 = LayerNorm(mid_dim)
        self.fc2 = Dense(mid_dim, mid_dim)
        self.ln2 = LayerNorm(mid_dim)
        self.fc3 = Dense(mid_dim, num_freq * in_dim * out_dim)
        for fc in (self.fc1, self.fc2, self.fc3):
            fc.he_uniform = True

    def forward(self, feat):
        x = torch.relu(self.ln1(self.fc1(feat)))
        x = torch.relu(self.ln2(self.fc2(x)))
        x = self.fc3(x)
        return x.reshape(*x.shape[:-1], self.out_dim, self.in_dim, self.num_freq)


class PairwiseConv(nn.Module):
    """Per-edge SE(3) kernel between two degrees; returns the radial weights
    (..., nc_out, nc_in, nf) (callers fuse the basis contraction)."""

    def __init__(self, degree_in: int, nc_in: int, degree_out: int, nc_out: int,
                 edge_dim: int = 0):
        super().__init__()
        self.rp = RadialFunc(2 * min(degree_in, degree_out) + 1, nc_in, nc_out, edge_dim)

    def forward(self, feat):
        return self.rp(feat)


class GConvSE3Partial(nn.Module):
    """Node -> edge partial convolution (the K and V embeddings of the
    attention). h[d] is (B, L, m, 2d+1) on the dense and scatter layouts and
    the gathered (B, J, S, m, 2d+1) on the gather layout. Output per degree:
    (B, m_out, 2d_out+1, J, S), or (B, m_out, 2d_out+1, I, S) keyed by source
    with src_major (the scatter layout: each slot's source is the row)."""

    def __init__(self, f_in: Fiber, f_out: Fiber, edge_dim: int = 0):
        super().__init__()
        self.f_in, self.f_out = f_in, f_out
        for do in f_out.degrees:
            for di in f_in.degrees:
                self.add_module(f"pc_{di}_{do}", PairwiseConv(
                    di, f_in.dict[di], do, f_out.dict[do], edge_dim))

    def forward(self, h: Features, edge_feat, basis, src_major: bool = False) -> Features:
        out = {}
        for do in self.f_out.degrees:
            msg = None
            for di in self.f_in.degrees:
                R = getattr(self, f"pc_{di}_{do}")(edge_feat)  # (B,J,S,mo,mi,nf)
                if src_major:  # scatter: row i's feature, shared by its S slots
                    t = torch.einsum("bismnf,bicn->bmfcis", basis[f"{di},{do}"], h[di])
                elif h[di].ndim == 4:  # dense: S == L, the node features themselves
                    t = torch.einsum("bjimnf,bicn->bmfcji", basis[f"{di},{do}"], h[di])
                else:
                    t = torch.einsum("bjsmnf,bjscn->bmfcjs", basis[f"{di},{do}"], h[di])
                contrib = torch.einsum("bjiocf,bmfcji->bomji", R, t)
                msg = contrib if msg is None else msg + contrib
            out[do] = msg
        return out


class G1x1SE3(nn.Module):
    """Per-degree linear channel mixing: W_d (m_out, m_in)."""

    def __init__(self, f_in: Fiber, f_out: Fiber):
        super().__init__()
        self.degrees = tuple(d for d in f_out.degrees if d in f_in.degrees)
        for d in self.degrees:
            self.register_parameter(
                f"W_{d}", nn.Parameter(torch.empty(f_out.dict[d], f_in.dict[d])))

    def forward(self, feats: Features) -> Features:
        return {d: torch.einsum("oc,...cm->...om", getattr(self, f"W_{d}"), feats[d])
                for d in self.degrees if d in feats}


class GNormBias(nn.Module):
    """Norm-gated nonlinearity with learned bias: ReLU(|v| + b) * v/|v|."""

    def __init__(self, fiber: Fiber, eps: float = 1e-12):
        super().__init__()
        self.fiber, self.eps = fiber, eps
        for d, m in fiber.dict.items():
            self.register_parameter(f"bias_{d}", nn.Parameter(torch.empty(m)))

    def forward(self, feats: Features) -> Features:
        out = {}
        for d in self.fiber.degrees:
            v = feats[d]
            norm = torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=self.eps)
            gated = torch.relu(norm[..., 0] + getattr(self, f"bias_{d}"))
            out[d] = gated[..., None] * (v / norm)
        return out


class GAttentiveSelfInt(nn.Module):
    """Attention-based self-interaction over the channel Gram matrix."""

    def __init__(self, f_in: Fiber, f_out: Fiber, eps: float = 1e-12):
        super().__init__()
        self.f_in, self.f_out, self.eps = f_in, f_out, eps
        for d in f_in.degrees:
            m_in, m_out = f_in.dict[d], f_out.dict[d]
            self.add_module(f"ln_{d}", LayerNorm(m_in * m_in))
            fc = Dense(m_in * m_in, m_in * m_out)
            fc.he_uniform = True
            self.add_module(f"fc_{d}", fc)

    def forward(self, feats: Features) -> Features:
        out = {}
        for d in self.f_in.degrees:
            v = feats[d]
            m_in, m_out = self.f_in.dict[d], self.f_out.dict[d]
            gram = torch.einsum("...ac,...bc->...ab", v, v)
            gram = gram.reshape(*gram.shape[:-2], m_in * m_in)
            gram = torch.sign(gram) * torch.clamp(gram.abs(), min=self.eps)
            t = torch.nn.functional.leaky_relu(getattr(self, f"ln_{d}")(gram), 0.01)
            t = getattr(self, f"fc_{d}")(t)
            att = torch.softmax(t.reshape(*t.shape[:-1], m_out, m_in), dim=-1)
            out[d] = torch.einsum("...nm,...md->...nd", att, v)
        return out


def _masked_softmax(logits, mask, dim: int):
    logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    att = torch.softmax(logits, dim=dim)
    return torch.where(mask, att, torch.zeros_like(att))


def _segment_sum(x, ids, n: int):
    """x (B, E, F) summed into n segments per batch by ids (B, E) -> (B, n, F)."""
    B, E, F = x.shape
    flat = (ids + n * torch.arange(B, device=ids.device)[:, None]).reshape(-1)
    return x.new_zeros(B * n, F).index_add_(0, flat, x.reshape(B * E, F)).reshape(B, n, F)


def _segment_max(x, ids, n: int):
    """Per-segment max of x (B, E, F) -> (B, n, F); an empty segment is -inf."""
    B, E, F = x.shape
    flat = (ids + n * torch.arange(B, device=ids.device)[:, None]).reshape(-1)
    out = x.new_full((B * n, F), float("-inf"))
    out.scatter_reduce_(0, flat[:, None].expand(-1, F), x.reshape(B * E, F), "amax",
                        include_self=False)
    return out.reshape(B, n, F)


def _take(x, ids):
    """x (B, n, F) read at ids (B, E) -> (B, E, F)."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


class GMABSE3(nn.Module):
    """Equivariant multi-head attention over incoming edges: dense and
    gather layouts (softmax over the slots of each destination), and the
    scatter layout with dst_idx (segment softmax over the edges that point
    at each destination)."""

    def __init__(self, f_value: Fiber, f_key: Fiber, n_heads: int):
        super().__init__()
        self.f_value, self.f_key, self.n_heads = f_value, f_key, n_heads

    def forward(self, v: Features, k: Features, q: Features, mask, dst_idx=None) -> Features:
        h = self.n_heads
        kh = torch.cat([
            k[d].reshape(k[d].shape[0], h, (m // h) * (2 * d + 1), *k[d].shape[-2:])
            for d, m in self.f_key.dict.items()], dim=2)  # (B, h, ck, J, S)
        qh = fiber2head(q, h, self.f_key)  # (B, J, h, ck)
        if dst_idx is not None:
            return self._scatter_attend(v, kh, qh, mask, dst_idx)
        e = torch.einsum("bhcjs,bjhc->bhjs", kh, qh) / math.sqrt(self.f_key.n_features)
        att = _masked_softmax(e, mask[:, None], dim=-1)
        out = {}
        for d, m in self.f_value.dict.items():
            vd = v[d].reshape(v[d].shape[0], h, m // h, 2 * d + 1, *v[d].shape[-2:])
            agg = torch.einsum("bhjs,bhcmjs->bjhcm", att, vd)
            out[d] = agg.reshape(*agg.shape[:2], m, 2 * d + 1)
        return out

    def _scatter_attend(self, v: Features, kh, qh, valid, dst_idx) -> Features:
        """edge_softmax and sum over the src-major edge list: kh (B, h, ck,
        I, S), qh (B, L, h, ck), dst_idx and valid (B, I, S). Invalid edges
        go to a segment L past the last and are dropped; a destination with
        no valid edge gets 0."""
        h = self.n_heads
        B, I, S = dst_idx.shape
        L, ck = qh.shape[1], qh.shape[-1]
        E = I * S
        idx, ok = dst_idx.long().reshape(B, E), valid.reshape(B, E)
        ids = torch.where(ok, idx, L)
        # q at each edge's destination (an invalid edge's index is never read)
        q_edge = _take(qh.reshape(B, L, h * ck), torch.where(ok, idx, 0)).reshape(B, I, S, h, ck)
        e = torch.einsum("bhcis,bishc->bhis", kh, q_edge) / math.sqrt(self.f_key.n_features)
        e = torch.where(valid[:, None], e, float("-inf")).reshape(B, h, E).transpose(1, 2)
        seg_max = torch.nan_to_num(_segment_max(e, ids, L + 1), neginf=0.0)  # (B, L+1, h)
        z = torch.exp(e - _take(seg_max, ids))                                # (B, E, h)
        z = torch.where(torch.isfinite(e), z, 0.0)
        att = z / torch.clamp(_take(_segment_sum(z, ids, L + 1), ids), min=1e-20)
        out = {}
        for d, m in self.f_value.dict.items():
            vd = v[d].reshape(B, h, m // h, 2 * d + 1, E)
            weighted = (att.transpose(1, 2)[:, :, None, None] * vd).reshape(B, -1, E)
            agg = _segment_sum(weighted.transpose(1, 2), ids, L + 1)[:, :L]  # (B, L, F)
            out[d] = agg.reshape(B, L, m, 2 * d + 1)
        return out


class GSE3Res(nn.Module):
    """Equivariant attention block with 'cat' skip: V, K from partial
    convolutions, Q from a 1x1, attention, then a 1x1 or attentive
    projection. impl="pallas" runs V/K + attention through kernel B."""

    def __init__(self, f_in: Fiber, f_out: Fiber, edge_dim: int = 0, div: float = 4,
                 n_heads: int = 1, selfint: str = "1x1", impl: str = "xla"):
        super().__init__()
        self.f_in, self.n_heads = f_in, n_heads
        self.f_mid_out = Fiber({d: int(m // div) for d, m in f_out.dict.items()})
        self.f_mid_in = Fiber({d: m for d, m in self.f_mid_out.dict.items()
                               if d in f_in.degrees})
        self.fused = (impl == "pallas" and f_in.degrees == (0, 1)
                      and self.f_mid_out.degrees == (0, 1)
                      and self.f_mid_in.degrees == (0, 1))
        self.v = GConvSE3Partial(f_in, self.f_mid_out, edge_dim)
        self.k = GConvSE3Partial(f_in, self.f_mid_in, edge_dim)
        self.q = G1x1SE3(f_in, self.f_mid_in)
        self.attn = GMABSE3(self.f_mid_out, self.f_mid_in, n_heads)
        if self.fused:
            self.meta = se3_attend.build_meta(
                f_in.dict, self.f_mid_out.dict, self.f_mid_in.dict, n_heads, edge_dim)
        cat_fiber = Fiber({d: m + f_in.dict.get(d, 0)
                           for d, m in self.f_mid_out.dict.items()})
        if selfint == "att":
            self.project = GAttentiveSelfInt(cat_fiber, f_out)
        else:
            self.project = G1x1SE3(cat_fiber, f_out)

    def forward(self, h: Features, edge_feat, basis, mask, src_idx=None,
                dst_idx=None) -> Features:
        """src_idx (B, J, S) int32: the gather layout; dst_idx (B, I, S) int32:
        the scatter layout, on the plain path under either impl (as JAX's
        SE3Transformer runs it); neither: dense."""
        q = self.q(h)
        if dst_idx is not None:
            z = self.attn(self.v(h, edge_feat, basis, src_major=True),
                          self.k(h, edge_feat, basis, src_major=True), q, mask, dst_idx)
        elif self.fused:
            # under tp: fc1's and fc2's gathered shards (the kernel takes whole weights)
            stacked = se3_attend.stack_weights(self.v, self.k, self.meta, whole=mesh.full)
            qh = fiber2head(q, self.n_heads, self.f_mid_in)
            qh = qh.reshape(*qh.shape[:2], -1).contiguous()
            z = se3_attend.gse3_attend(
                edge_feat, basis, {d: t.contiguous() for d, t in h.items()}, mask, qh,
                stacked, self.meta, src_idx)
        else:
            src = h if src_idx is None else {
                d: se3_attend.gather_src(t, src_idx) for d, t in h.items()}
            z = self.attn(self.v(src, edge_feat, basis), self.k(src, edge_feat, basis), q,
                          mask)
        z = {d: torch.cat([z[d], h[d]], dim=-2) if d in h else z[d]
             for d in self.f_mid_out.degrees}
        return self.project(z)


class SE3Transformer(nn.Module):
    """num_layers x (GSE3Res + GNormBias) + a final GSE3Res (div 1, one head,
    attentive self-interaction). The basis and radii are computed once per
    call; the Q_J tables are registered buffers.

    Call: h0 (B, L, l0_in, 1), h1 (B, L, l1_in, 3), edge_feat (B, L, S, edge),
    rel_pos (B, L, S, 3) [= x_dst - x_src], mask (B, L, S) bool, and for the
    gather layout src_idx (B, L, S) int32, for the scatter layout dst_idx
    (B, L, S) int32 with src-major edge tensors (dense: S == L, neither).
    Returns {0: (B, L, l0_out, 1), 1: (B, L, l1_out, 3)}."""

    def __init__(self, num_layers: int = 2, num_channels: int = 16, num_degrees: int = 2,
                 n_heads: int = 4, div: int = 4, si_m: str = "1x1", si_e: str = "att",
                 l0_in_features: int = 32, l0_out_features: int = 32,
                 l1_in_features: int = 3, l1_out_features: int = 3,
                 num_edge_features: int = 32, impl: str = "xla"):
        super().__init__()
        self.num_layers, self.max_degree = num_layers, num_degrees - 1
        f_in = Fiber({0: l0_in_features, 1: l1_in_features})
        f_mid = Fiber(num_degrees=num_degrees, num_channels=num_channels)
        f_out = (Fiber({0: l0_out_features, 1: l1_out_features}) if l1_out_features > 0
                 else Fiber({0: l0_out_features}))
        fin = f_in
        for i in range(num_layers):
            self.add_module(f"res_{i}", GSE3Res(fin, f_mid, num_edge_features, div,
                                                n_heads, si_m, impl))
            self.add_module(f"norm_{i}", GNormBias(f_mid))
            fin = f_mid
        self.res_out = GSE3Res(f_mid, f_out, num_edge_features, 1, 1, si_e, impl)
        self._q_keys = []
        for key, table in so3.q_tables(self.max_degree).items():
            self.register_buffer(f"q_{key}", table, persistent=False)
            self._q_keys.append(key)

    def forward(self, h0, h1, edge_feat, rel_pos, mask, src_idx=None, dst_idx=None) -> Features:
        tables = {k: getattr(self, f"q_{k}") for k in self._q_keys}
        basis = so3.equivariant_basis(rel_pos, self.max_degree, tables)
        r = so3.edge_radii(rel_pos)
        feat = torch.cat([edge_feat.float(), r.float()], dim=-1)
        h = {0: h0.float(), 1: h1.float()}
        for i in range(self.num_layers):
            h = getattr(self, f"res_{i}")(h, feat, basis, mask, src_idx, dst_idx)
            h = getattr(self, f"norm_{i}")(h)
        return self.res_out(h, feat, basis, mask, src_idx, dst_idx)
