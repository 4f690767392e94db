"""Plain PyTorch versions of the hand-written kernels (the contracts).

Every tensor carries a leading instance axis ``B``: the reference's
per-instance functions under ``vmap`` become one batched call here.

``neighbor_info``
    The masked O(N²) lead/follower search of ``repro/core/neighbors.py``
    (``neighbor_info``), batched: ``[B, N]`` inputs and one query-lane
    vector per instance.
``ref_neighbor_mq``
    The multi-query contract of ``neighbor_kernel``: ``[B, Q, N]`` query
    lanes (or Q rows, row q asking for lane q), one ``neighbor_info`` per
    query row.
``ref_idm_accel``
    Same-lane lead search fused with the IDM formula
    (``repro/kernels/ref.py::ref_idm_accel``), batched.
``ref_attention``
    The contract of ``flash_attention`` (``repro/kernels/ref.py::
    ref_attention``): GQA attention with end-aligned causal masking, a
    sliding window and the tanh logit softcap; scores and softmax in f32,
    the probabilities cast to ``v``'s type before the product with ``v``.
``ref_rglru``
    The contract of ``rglru_linear_scan`` (``repro/kernels/ref.py::
    ref_rglru``): ``h_t = a_t * h_{t-1} + x_t``, one step at a time in f32.
``ref_wkv6``
    The contract of ``wkv6`` (``repro/kernels/ref.py::ref_wkv6``): the
    WKV6 recurrence, one step at a time over the f32 ``[B, H, K, V]``
    state.
"""

from __future__ import annotations

import torch

INF = 1e9
NEG_INF = -2.0**30


def neighbor_info(pos, lane, active, veh_len, query_lane):
    """Per-vehicle lead/follower in ``query_lane[b, i]``.

    ``pos`` f32, ``lane``/``query_lane`` i32, ``active`` bool, all
    ``[B, N]``. Returns ``(lead_idx, lead_gap, has_lead, foll_idx,
    foll_gap, has_foll)``, each ``[B, N]``: strict ahead/behind, lowest
    index on ties, absent = (0, ``INF - veh_len``, False); gaps are
    bumper to bumper.
    """
    n = pos.shape[-1]
    dpos = pos[:, None, :] - pos[:, :, None]          # [b,i,j] = pos_j - pos_i
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    pair_ok = (
        (lane[:, None, :] == query_lane[:, :, None])
        & active[:, None, :]
        & active[:, :, None]
        & ~eye
    )
    ahead = pair_ok & (dpos > 0.0)
    behind = pair_ok & (dpos < 0.0)
    inf = torch.tensor(INF, dtype=pos.dtype, device=pos.device)

    lead_d = torch.where(ahead, dpos, inf)
    lead_idx = lead_d.argmin(dim=-1).to(torch.int32)
    lead_gap = lead_d.amin(dim=-1) - veh_len
    has_lead = ahead.any(dim=-1)

    foll_d = torch.where(behind, -dpos, inf)
    foll_idx = foll_d.argmin(dim=-1).to(torch.int32)
    foll_gap = foll_d.amin(dim=-1) - veh_len
    has_foll = behind.any(dim=-1)
    return lead_idx, lead_gap, has_lead, foll_idx, foll_gap, has_foll


def ref_neighbor_mq(pos, lane, active, query_lanes, veh_len, *,
                    n_rows=None):
    """``[B, N]`` world + ``[B, Q, N]`` query lanes → six ``[B, Q, N]``
    tensors (lead idx/gap/has, follower idx/gap/has). With ``query_lanes``
    ``None``, ``n_rows`` rows: row ``q`` queries lane ``q``."""
    if query_lanes is None:
        rows = [torch.full_like(lane, q) for q in range(n_rows)]
    else:
        rows = [query_lanes[:, q] for q in range(query_lanes.shape[1])]
    per_q = [neighbor_info(pos, lane, active, veh_len, r) for r in rows]
    return tuple(torch.stack(f, dim=1) for f in zip(*per_q))


def ref_idm_accel(pos, vel, lane, active, v0, T, a_max, b_comf, s0, veh_len):
    """Same-lane lead search + IDM acceleration, ``[B, N]`` → ``[B, N]``."""
    n = pos.shape[-1]
    dpos = pos[:, None, :] - pos[:, :, None]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    ahead = (
        (lane[:, None, :] == lane[:, :, None])
        & active[:, None, :] & active[:, :, None] & ~eye & (dpos > 0)
    )
    inf = torch.tensor(INF, dtype=pos.dtype, device=pos.device)
    lead_d = torch.where(ahead, dpos, inf)
    lead_idx = lead_d.argmin(dim=-1)
    has_lead = ahead.any(dim=-1)
    gap = torch.where(has_lead, lead_d.amin(dim=-1) - veh_len, inf)
    v_lead = torch.where(has_lead, vel.gather(-1, lead_idx), 0.0)
    dv = torch.where(has_lead, vel - v_lead, 0.0)

    gap = gap.clamp_min(0.1)
    s_star = s0 + (vel * T + vel * dv / (2.0 * torch.sqrt(a_max * b_comf))
                   ).clamp_min(0.0)
    r = vel / v0.clamp_min(0.1)
    r2 = r * r
    g = s_star / gap
    return a_max * (1.0 - r2 * r2 - g * g)


def ref_attention(q, k, v, causal=True, window=0, softcap=0.0, scale=None):
    """``q [B, Sq, H, D]``, ``k [B, Sk, K, D]``, ``v [B, Sk, K, Dv]`` →
    ``[B, Sq, H, Dv]`` in ``v``'s type. Query ``i`` sits at position ``i + Sk - Sq``; masked
    scores take the finite ``NEG_INF``."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(b, sq, kh, g, d)
    # bf16 products are exact in f32, so this is the reference's f32 score
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(b, sq, h, v.shape[-1])


def ref_rglru(a, x, h0):
    """``a`` (decay), ``x`` ``[B, S, W]``, ``h0 [B, W]`` → ``(ys [B, S, W]
    f32, h_final [B, W] f32)`` with ``h_t = a_t * h_{t-1} + x_t``."""
    af, xf = a.float(), x.float()
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys.append(h)
    ys = torch.stack(ys, dim=1) if ys else xf.new_zeros(xf.shape)
    return ys, h


def ref_wkv6(r, k, v, w, u, s0):
    """``r``, ``k``, ``w`` ``[B, S, H, K]``, ``v [B, S, H, V]``, ``u [H, K]``,
    ``s0 [B, H, K, V]`` → ``(y [B, S, H, V] f32, S_final [B, H, K, V] f32)``:
    ``y_t = r_tᵀ(S + u⊙k_t v_tᵀ)``, then ``S ← w_t⊙S + k_t v_tᵀ``."""
    rf, kf, vf, wf = (z.float() for z in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else vf.new_zeros(vf.shape)
    return y, state
