"""Mixture-of-Experts with the NAM/RRJ dispatch (a port of
``repro.models.moe``).

With no sharding policy JAX's ``apply_moe`` runs ``_moe_reference``, the
loop in which every token goes through every expert.  The port keeps
that loop as the plain version (:func:`_moe_reference`; decode runs it,
as JAX's does) and computes the same function on the prefill and
training path by packing (:func:`_moe_packed`): the router's rank kernel
(``kernels/radix_partition.py`` ``rank``) bins the T * top_k
assignments by expert with capacity T, so none drops (a token's top-k
experts are distinct), each expert's SwiGLU runs on its own rows only,
and the gate-weighted outputs come back to their tokens in the
reference's order of additions.  Under ``impl="plain"`` the same packing
takes the rank's plain twin, so both paths build the same rows.

Under a policy whose mesh has a ``model`` axis of more than one shard
that divides the experts, ``apply_moe`` runs JAX's expert-parallel
dispatch over the mesh's shards (``launch/mesh.py``: emulated on one
card, a host thread a shard):

  - :func:`_moe_rrj` (prefill): the paper's RDMA Radix Join mapped to
    tokens.  Each shard bins its tokens' assignments by owner shard into
    fixed-capacity send buffers (§5.2's software-managed buffers: the
    router's rank and scatter kernels, ``fabric/router.py``), one
    ``all_to_all`` over 'model' ships them, a second radix pass (rank
    and scatter again) bins the received rows by local expert, the
    experts run, and the paired ``all_to_all`` returns the results.
    Expert weights are FSDP-sharded over 'data' and gathered in the
    body (the one-sided READ).  Assignments past a buffer's capacity
    drop, as in JAX: which ones depends on the order of arrival, which
    is JAX's (token-major, each token's experts in top-k order);
  - :func:`_moe_replicated` (decode, or one position): every shard sees
    the few tokens, bins those routed to its own experts (one rank and
    one scatter), multiplies its D-slice of the weights, and two psums
    assemble the result: the weights stay put.

The combine adds a token's k gate-weighted results in top-k order (a
fixed order: no atomics), and every collective combines in the order of
its axis, so the kernel path and the plain path give the same values.

The route packs rows into int32 lanes, so autograd cannot flow through
it: the RRJ carries a backward of its own (:class:`_RRJFn`), which
routes the gradient back along the forward's plans, and which trains
through the RRJ as JAX's ``jax.grad`` does.  The decode twin has none
(JAX never trains through it).
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.fabric.router import plan_route, route
from repro_torch.kernels import ops
from repro_torch.launch.mesh import shard_map
from repro_torch.sharding.policy import P, current_policy


def build_moe(cfg, mcfg, mk):
    d, f, e = cfg.d_model, mcfg.d_ff, mcfg.num_experts
    p = {"router": mk((d, e), ("embed", None)),
         "wi": mk((e, d, 2 * f), ("experts", "embed", None)),
         "wo": mk((e, f, d), ("experts", None, "embed"))}
    if mcfg.num_shared:
        sf = mcfg.shared_d_ff or f
        p["shared_wi"] = mk((d, 2 * sf * mcfg.num_shared), ("embed", "ff"))
        p["shared_wo"] = mk((sf * mcfg.num_shared, d), ("ff", "embed"))
    return p


def _gates(mcfg, xt, router_w):
    """xt: (T, D) -> (top-k gates (T, k) renormalized, expert ids (T, k),
    probabilities (T, E)).  Ids in descending probability; among equal
    probabilities the lower id first, as ``jax.lax.top_k`` takes them
    (``torch.topk`` does not promise an order for ties, a stable sort
    does)."""
    logits = xt.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    svals, sidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = svals[:, :mcfg.top_k], sidx[:, :mcfg.top_k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return vals, idx, probs


def _expert_ffn(h_in, wi, wo):
    """One expert's SwiGLU: h_in (C, D), wi (D, 2F), wo (F, D)."""
    g, u = (h_in @ wi).chunk(2, dim=-1)
    return (F.silu(g) * u) @ wo


def _expert_ffn_grouped(h_in, wi, wo):
    """Every local expert's SwiGLU at once: h_in (E, C, D), wi (E, D, 2F),
    wo (E, F, D)."""
    g, u = torch.bmm(h_in, wi).chunk(2, dim=-1)
    return torch.bmm(F.silu(g) * u, wo)


def aux_load_balance(mcfg, xt, router_w):
    """Switch-style load-balancing loss: E * sum_e f_e * p_e, f_e the
    tokens' mean count of assignments to e, p_e their mean probability."""
    _, idx, probs = _gates(mcfg, xt, router_w)
    e = mcfg.num_experts
    # JAX's one_hot as a comparison: ``F.one_hot`` runs other aten ops on
    # the meta device than on the card, and a step's count on meta must
    # equal the card's (``launch/roofline.py``)
    hot = idx[..., None] == torch.arange(e, device=idx.device)
    f = hot.to(torch.float32).sum(1).mean(0)
    return e * torch.sum(f * probs.mean(0))


def _moe_reference(cfg, mcfg, p, x):
    """The loop over experts: every token through every expert, ``out``
    accumulated in x's dtype in expert order 0..E-1.  Exact (no token
    dropped); the plain version of :func:`_moe_packed`."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    vals, idx, _ = _gates(mcfg, xt, p["router"])
    out = torch.zeros_like(xt)
    for e in range(mcfg.num_experts):
        w = torch.where(idx == e, vals, 0.0).sum(-1)             # (T,)
        y = _expert_ffn(xt, p["wi"][e].to(x.dtype), p["wo"][e].to(x.dtype))
        out = out + y * w[:, None].to(x.dtype)
    return out.reshape(B, S, D)


def _moe_packed(cfg, mcfg, p, x, *, impl=None):
    """:func:`_moe_reference`'s function with each expert on its own rows.

    The assignments (token t's k experts, in ascending id) are ranked by
    expert into E buckets of cap T (``ops.rank``: the kernel on the card);
    row = exclusive-cumsum(counts)[e] + rank packs them by expert in
    arrival order.  The per-expert row counts come to the host once (one
    sync a layer) to cut the packed rows.  A token's outputs are added to
    zeros in ascending expert id, the order in which the reference adds
    them, each rounded to x's dtype."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T, k, E = xt.shape[0], mcfg.top_k, mcfg.num_experts
    vals, idx, _ = _gates(mcfg, xt, p["router"])
    idx, order = idx.sort(dim=-1)
    vals = vals.gather(-1, order)
    dest = idx.reshape(-1).to(torch.int32)                      # (A,)
    slot, _, _, counts = ops.rank(dest, E, T, impl=impl)
    ends = torch.cumsum(counts, 0)
    row = (ends - counts)[dest.long()] + slot - dest * T        # (A,) int64
    src = torch.empty_like(row)
    src[row] = torch.arange(T * k, dtype=row.dtype, device=row.device) // k
    xs = xt[src]                                                # packed
    ys, lo = [], 0
    for e, hi in enumerate(ends.tolist()):
        if hi > lo:
            ys.append(_expert_ffn(xs[lo:hi], p["wi"][e].to(x.dtype),
                                  p["wo"][e].to(x.dtype)))
        lo = hi
    y = torch.cat(ys)[row].reshape(T, k, D)
    y = y * vals[..., None].to(x.dtype)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + y[:, j]
    return out.reshape(B, S, D)


# ------------------------------------------------------------------- RRJ --

def _round8(n: int) -> int:
    return max(8, int(math.ceil(n / 8)) * 8)


def _zero_row(y):
    """y with a zero row appended: the row a dropped slot reads."""
    return torch.cat([y, y.new_zeros((1,) + tuple(y.shape[1:]))])


def _radix_to_buffers(xt, dest, src_slot, meta, num_dest: int, cap: int, *,
                      impl=None):
    """Software-managed buffer fill (paper §5.2): the assignments binned by
    destination in arrival order, those past a destination's ``cap``
    dropped, into (num_dest, cap) send buffers; a ``dest`` outside
    [0, num_dest) is not sent.  The router's rank (``plan_route``) and
    scatter (``route``): the kernels on the card.

    xt: (T, D) tokens; dest: (A,) destination ids; src_slot: (A,) source
    token of each assignment; meta: dict of (A,) payload scalars.
    Returns (buf (num_dest*cap, D), meta_buf, valid (num_dest*cap,) f32,
    the plan); empty slots are zero, as in JAX's."""
    plan = plan_route(dest, n=num_dest, cap=cap, impl=impl)
    res = route((xt[src_slot.long()], meta), plan=plan, impl=impl)
    buf, mbuf = res.sent
    return buf, mbuf, res.sent_valid.to(torch.float32), plan


def _combine(y, plan, gates, T: int, k: int, dtype):
    """Each assignment's result (``y``'s row at its slot, the zero row if
    dropped) times its gate in ``dtype``, a token's k added to zeros in
    top-k order."""
    w = torch.where(plan.keep, gates, 0.0).to(dtype)
    ya = (_zero_row(y)[plan.slot.long()] * w[:, None]).reshape(T, k, -1)
    out = torch.zeros_like(ya[:, 0])
    for j in range(k):
        out = out + ya[:, j]
    return out


def _a2a(mesh, tp: int, cap: int):
    """The paired all-to-all over 'model' of a (tp * cap, ...) buffer."""
    def a2a(v):
        return mesh.all_to_all(v.reshape((tp, cap) + tuple(v.shape[1:])),
                               "model", 0, 0).reshape(
                                   (tp * cap,) + tuple(v.shape[1:]))
    return a2a


def _moe_rrj_body(mcfg, mesh, tp: int, cap: int, ecap: int, impl,
                  kept: bool, saved, x, router_w, wi, wo):
    """shard_map body. x: (B_l, S_l, D); wi: (E_l, D/dp, 2F); wo likewise.
    ``saved``: None, or a list whose entry for this shard takes what the
    backward needs (the two plans, the expert inputs, the results)."""
    local_e = wi.shape[0]
    B_l, S_l, D = x.shape
    k = mcfg.top_k
    # NAM one-sided READ: fetch the FSDP-sharded expert weights for this
    # shard, cast to the compute dtype before the gather
    wi = mesh.all_gather(wi.to(x.dtype), "data", dim=1)
    wo = mesh.all_gather(wo.to(x.dtype), "data", dim=2)

    xt = x.reshape(-1, D)
    T = xt.shape[0]
    vals, idx, _ = _gates(mcfg, xt, router_w)
    e_flat = idx.reshape(-1).to(torch.int32)
    src = torch.arange(T, device=x.device).repeat_interleave(k)
    dest = torch.div(e_flat, local_e, rounding_mode="floor")  # owner shard
    a2a = _a2a(mesh, tp, cap)

    # first radix pass and the network shuffle: one packed buffer (token
    # row, local expert, valid lane) through one all_to_all
    plan = plan_route(dest, n=tp, cap=cap, impl=impl)
    got = route((xt[src], e_flat % local_e), plan=plan, exchange=a2a,
                impl=impl)
    rows, rle = got.fields
    # second radix pass: received rows by local expert; invalid rows are
    # not binned (their lanes are the zeros of empty slots)
    rle = torch.where(got.valid > 0, rle, local_e)
    plan2 = plan_route(rle, n=local_e, cap=ecap, impl=impl)
    ebuf = route((rows,), plan=plan2, impl=impl).sent[0]
    y = _expert_ffn_grouped(ebuf.reshape(local_e, ecap, D), wi, wo)
    del wi, wo
    # un-bin: each received row reads its own slot, a dropped one zeros
    back = _zero_row(y.reshape(local_e * ecap, D))[plan2.slot.long()]
    # reverse shuffle, then combine into source tokens, gate-weighted
    sb = a2a(back)
    out = _combine(sb, plan, vals.reshape(-1), T, k, x.dtype)
    out = out.reshape(B_l, S_l, D)
    if saved is not None:
        saved[mesh.shard_index()] = (plan, plan2, ebuf, sb)
    if not kept:
        return out
    kept2 = _zero_row(a2a(plan2.keep.to(torch.int32)))[plan.slot.long()]
    return out, (plan.keep & (kept2 > 0)).reshape(B_l, S_l, k)


def _gates_grad(mcfg, xt, router_w, d_vals):
    """The gradients of (xt, router_w) of :func:`_gates`' renormalized
    top-k gates given theirs, ``d_vals`` (T, k) f32, in closed form: the
    renormalization's, the top-k's scatter, the softmax's and the router
    product's backward.  A shard body cannot call autograd: on the card
    the engine runs a backward's device work on one thread, which is
    waiting for the shards."""
    f32 = torch.float32
    x32, r32 = xt.to(f32), router_w.to(f32)
    probs = torch.softmax(x32 @ r32, dim=-1)
    svals, sidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    raw, idx = svals[:, :mcfg.top_k], sidx[:, :mcfg.top_k]
    s = raw.sum(-1, keepdim=True)
    sc = torch.clamp_min(s, 1e-9)
    d_s = -(d_vals * raw).sum(-1, keepdim=True) / (sc * sc)
    d_raw = d_vals / sc + torch.where(s >= 1e-9, d_s, 0.0)
    d_probs = torch.zeros_like(probs).scatter(-1, idx, d_raw)
    d_logits = probs * (d_probs - (d_probs * probs).sum(-1, keepdim=True))
    return (d_logits @ r32.T).to(xt.dtype), (x32.T @ d_logits)


def _expert_ffn_grad(h_in, wi, wo, d_y):
    """The gradients of (h_in, wi, wo) of :func:`_expert_ffn_grouped`
    given its output's, ``d_y``: the ops autograd runs for it, written
    out (see :func:`_gates_grad`)."""
    h = torch.bmm(h_in, wi)
    g, u = h.chunk(2, dim=-1)
    a = F.silu(g)
    m = a * u
    d_wo = torch.bmm(m.transpose(1, 2), d_y)
    d_m = torch.bmm(d_y, wo.transpose(1, 2))
    d_h = torch.cat([torch.ops.aten.silu_backward(d_m * u, g), d_m * a], -1)
    return (torch.bmm(d_h, wi.transpose(1, 2)),
            torch.bmm(h_in.transpose(1, 2), d_h), d_wo)


def _moe_rrj_grad_body(mcfg, mesh, tp: int, cap: int, ecap: int, impl,
                       saved, g, x, router_w, wi, wo):
    """The RRJ's backward on one shard, along the forward's own plans (no
    rank runs): the combine's gathers become scatters by the same slots
    (the scatter kernel on the card, with the rank's counts), the
    scatters gathers, the two all-to-alls run in reverse, the experts'
    SwiGLU is differentiated on the saved expert inputs and the
    re-gathered weights, whose gradient is reduce-scattered over 'data'.
    The gates' gradient is each kept assignment's result row against its
    token's output gradient; a token's k input gradients are added in
    top-k order.  Dropped assignments carry no gradient.  Returns the
    gradients of (x, router_w, wi, wo) of this shard."""
    plan, plan2, ebuf, sb = saved[mesh.shard_index()]
    local_e = wi.shape[0]
    B_l, S_l, D = x.shape
    k = mcfg.top_k
    dt = x.dtype
    T = B_l * S_l
    xt = x.reshape(T, D)
    gt = g.reshape(T, D).to(dt)
    a2a = _a2a(mesh, tp, cap)
    vals, _, _ = _gates(mcfg, xt, router_w)
    w = torch.where(plan.keep, vals.reshape(-1), 0.0).to(dt)
    g_rows = gt.repeat_interleave(k, dim=0)                      # (A, D)
    # the combine: d gate = its result row . its token's gradient
    ya = _zero_row(sb)[plan.slot.long()]
    d_vals = (g_rows * ya).sum(-1).to(torch.float32).reshape(T, k)
    d_vals = torch.where(plan.keep.reshape(T, k), d_vals, 0.0)
    dx_gate, d_router = _gates_grad(mcfg, xt, router_w, d_vals)
    # the combine's gather -> a scatter by the first plan's slots, then
    # the reverse shuffle, then the un-bin's gather -> a scatter by the
    # second plan's slots: each expert slot's output gradient
    d_sb = route((g_rows * w[:, None],), plan=plan, impl=impl).sent[0]
    d_back = a2a(d_sb)
    d_y = route((d_back,), plan=plan2, impl=impl).sent[0]
    del d_sb, d_back
    wi_f = mesh.all_gather(wi.to(dt), "data", dim=1)
    wo_f = mesh.all_gather(wo.to(dt), "data", dim=2)
    d_e, d_wi, d_wo = _expert_ffn_grad(ebuf.reshape(local_e, ecap, D),
                                       wi_f, wo_f,
                                       d_y.reshape(local_e, ecap, D))
    del wi_f, wo_f, d_y
    d_wi = mesh.psum_scatter(d_wi, "data", dim=1).to(wi.dtype)
    d_wo = mesh.psum_scatter(d_wo, "data", dim=2).to(wo.dtype)
    # the second pass's scatter -> a gather; the first shuffle in
    # reverse; the first pass's scatter -> a gather
    d_rows = _zero_row(d_e.reshape(local_e * ecap, D))[plan2.slot.long()]
    d_xa = _zero_row(a2a(d_rows))[plan.slot.long()].reshape(T, k, D)
    dx = torch.zeros_like(d_xa[:, 0])
    for j in range(k):
        dx = dx + d_xa[:, j]
    dx = dx + dx_gate
    d_router = mesh.psum(d_router, ("data", "model")).to(router_w.dtype)
    return dx.reshape(B_l, S_l, D), d_router, d_wi, d_wo


class _RRJFn(torch.autograd.Function):
    """The RRJ dispatch with its backward (:func:`_moe_rrj_grad_body`)."""

    @staticmethod
    def forward(ctx, x, router_w, wi, wo, setup):
        mesh, xspec, args = setup
        saved = [None] * mesh.size
        f = shard_map(partial(_moe_rrj_body, *args, False, saved), mesh,
                      (xspec,) + _W_SPECS, xspec)
        out = f(x, router_w, wi, wo)
        ctx.setup, ctx.saved = setup, saved
        ctx.save_for_backward(x, router_w, wi, wo)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, xspec, args = ctx.setup
        f = shard_map(partial(_moe_rrj_grad_body, *args, ctx.saved), mesh,
                      (xspec, xspec) + _W_SPECS, (xspec,) + _W_SPECS)
        grads = f(g.contiguous(), *ctx.saved_tensors)
        ctx.saved = None
        return (*grads, None)


def _batch(pol, x) -> tuple:
    """(the policy's mesh, the batch's mesh axes, their shard count),
    checked against x."""
    mesh = pol.mesh
    axes = P.names(pol.rules.get("batch"))
    n = math.prod(mesh.shape[a] for a in axes)
    if x.shape[0] % n:
        raise ValueError(f"the MoE batch of shape {tuple(x.shape)} does not "
                         f"split over {axes} of mesh {mesh.shape}")
    if mesh.device != x.device:
        raise ValueError(f"the mesh runs on {mesh.device}, the tokens lie "
                         f"on {x.device}")
    return mesh, axes, n


_W_SPECS = (P(None, None), P("model", "data", None), P("model", None, "data"))


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _moe_rrj(cfg, mcfg, p, x, *, impl=None, kept: bool = False):
    """The RRJ dispatch over the policy's mesh; with ``kept``, also
    (B, S, top_k) bool: which assignments reached their expert.  When a
    gradient is wanted, the dispatch runs with its backward
    (:class:`_RRJFn`), which returns no ``kept``."""
    mesh, batch_axes, bsh = _batch(current_policy(), x)
    tp = mesh.shape["model"]
    B, S, D = x.shape
    if S % tp:
        raise ValueError(f"the MoE sequence of shape {tuple(x.shape)} does "
                         f"not split over 'model' of mesh {mesh.shape}")
    T_local = (B // bsh) * (S // tp)
    local_e = mcfg.num_experts // tp
    # software-managed buffer capacities (paper: reserve remote buffers)
    cap = _round8(int(T_local * mcfg.top_k / tp * mcfg.capacity_factor))
    ecap = min(_round8(int(tp * cap / local_e * mcfg.capacity_factor)),
               _round8(tp * cap))
    xspec = P(batch_axes, "model", None)
    args = (mcfg, mesh, tp, cap, ecap, impl)
    ws = (p["router"], p["wi"], p["wo"])
    if _wants_grad(x, *ws):
        if kept:
            raise NotImplementedError(
                "the RRJ's backward returns no kept mask: ask for it "
                "where no gradient is wanted")
        return _RRJFn.apply(x, *ws, (mesh, xspec, args))
    body = partial(_moe_rrj_body, *args, kept, None)
    f = shard_map(body, mesh, (xspec,) + _W_SPECS,
                  (xspec, xspec) if kept else xspec)
    return f(x, *ws)


# ---------------------------------------------------------------- decode --

def _moe_replicated_body(mcfg, mesh, do_gather: bool, impl, kept: bool,
                         x, router_w, wi, wo):
    """Decode dispatch: the expert weights stay (E/tp, D/dp, F)-sharded;
    every shard sees all (few) tokens (an all_gather over 'data'), bins
    those routed to its own experts into capacity buffers (local: no
    shuffle), multiplies its D-slice of the weights, and two psums
    (data: hidden partials; model: the experts' combine) assemble the
    result."""
    local_e = wi.shape[0]
    B_l, S_l, D = x.shape
    d_l = wi.shape[1]                                  # D / dp
    dp = D // d_l
    k = mcfg.top_k
    me_m = mesh.axis_index("model")
    me_d = mesh.axis_index("data")

    xt = x.reshape(-1, D)
    xt_all = (mesh.all_gather(xt, "data", dim=0)
              if do_gather and dp > 1 else xt)
    T = xt_all.shape[0]
    vals, idx, _ = _gates(mcfg, xt_all, router_w)
    a_flat = idx.reshape(-1).to(torch.int32)
    src = torch.arange(T, device=x.device).repeat_interleave(k)
    # assignments owned by my model shard -> local expert bins
    mine = torch.div(a_flat, local_e, rounding_mode="floor") == me_m
    dest = torch.where(mine, a_flat % local_e, local_e)
    cap = _round8(int(T * k / max(local_e, 1) * mcfg.capacity_factor))
    cap = min(cap, _round8(T * k))
    # bin my D-slice of the tokens (the weights' D shard) into the bins
    ebuf, _, _, plan = _radix_to_buffers(
        xt_all[:, me_d * d_l:(me_d + 1) * d_l], dest, src, {}, local_e, cap,
        impl=impl)
    h = torch.bmm(ebuf.reshape(local_e, cap, d_l), wi.to(x.dtype))
    h = mesh.psum(h, "data")                           # (E_l, cap, 2F)
    g, u = h.chunk(2, dim=-1)
    y = torch.bmm(F.silu(g) * u, wo.to(x.dtype))       # (E_l, cap, D/dp)
    out = _combine(y.reshape(local_e * cap, d_l), plan, vals.reshape(-1),
                   T, k, x.dtype)
    out = mesh.psum(out, "model")
    out = mesh.all_gather(out, "data", dim=1)          # (T, D)
    mine_rows = slice(me_d * B_l * S_l, (me_d + 1) * B_l * S_l)
    if T != xt.shape[0]:
        out = out[mine_rows]
    out = out.reshape(B_l, S_l, D)
    if not kept:
        return out
    got = mesh.psum(plan.keep.to(torch.int32), "model").reshape(T, k)
    if T != xt.shape[0]:
        got = got[mine_rows]
    return out, (got > 0).reshape(B_l, S_l, k)


def _moe_replicated(cfg, mcfg, p, x, *, impl=None, kept: bool = False):
    """The decode dispatch (:func:`_moe_replicated_body`) over the
    policy's mesh.  It has no backward (its route packs rows into int32
    lanes, and nothing trains through decode): it raises when a gradient
    is wanted."""
    if _wants_grad(x, p["router"], p["wi"], p["wo"]):
        raise NotImplementedError(
            "the decode MoE dispatch has no backward: its route packs rows "
            "into int32 lanes; a gradient runs through the full-sequence "
            "RRJ")
    mesh, batch_axes, _ = _batch(current_policy(), x)
    xspec = P(batch_axes, None, None)
    body = partial(_moe_replicated_body, mcfg, mesh, bool(batch_axes), impl,
                   kept)
    f = shard_map(body, mesh, (xspec,) + _W_SPECS,
                  (xspec, xspec) if kept else xspec)
    return f(x, p["router"], p["wi"], p["wo"])


# ------------------------------------------------------------------ api ---

def apply_moe(cfg, mcfg, p, x, *, decode: bool = False, impl=None):
    """x: (B, S, D) -> (y, aux loss).  With no policy, a ``model`` axis of
    one shard, or experts it does not divide: decode runs the reference
    loop (JAX's one-device decode), the full sequence the packed experts.
    Otherwise decode or one position runs :func:`_moe_replicated` (no
    backward), the full sequence :func:`_moe_rrj` (with one).  ``impl`` picks the kernels' dispatch
    (None: the kernels on the card).  Shared experts are a dense SwiGLU
    added to every token."""
    pol = current_policy()
    xt = x.reshape(-1, x.shape[-1])
    aux = aux_load_balance(mcfg, xt, p["router"])
    tp = 1 if pol is None else pol.mesh.shape.get("model", 1)
    if tp == 1 or mcfg.num_experts % tp:
        y = (_moe_reference(cfg, mcfg, p, x) if decode
             else _moe_packed(cfg, mcfg, p, x, impl=impl))
    else:
        y = (_moe_replicated(cfg, mcfg, p, x, impl=impl)
             if decode or x.shape[1] == 1
             else _moe_rrj(cfg, mcfg, p, x, impl=impl))
    if mcfg.num_shared:
        g, u = torch.einsum("bsd,df->bsf", x, p["shared_wi"].to(
            x.dtype)).chunk(2, dim=-1)
        y = y + torch.einsum("bsf,fd->bsd", F.silu(g) * u,
                             p["shared_wo"].to(x.dtype))
    return y, aux
