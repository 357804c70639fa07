"""DeepSeek-V3's mixture of experts, told which experts it holds.

``MoE(x) = Σ_{i ∈ chosen ∩ held} wᵢ · SwiGLUᵢ(x) + SwiGLU_shared(x)``:

* the router (``gate``) spans every routed expert, in float32 as the
  published ``MoEGate`` does: ``s = σ(W_r·x)``; the top ``k`` of
  ``s + b`` are chosen, ``b`` a buffer (``e_score_correction_bias``) that
  no gradient moves; the weights are ``s`` over the chosen experts,
  renormalised (``norm_topk_prob``) and times ``routed_scaling_factor``.
  With one group (``n_group = topk_group = 1``) the published group limit
  selects every expert, and is left out;
* the layer holds the routed experts ``held`` (a range of the ids, one
  expert-parallel rank's share) and computes their part of the result for
  the rows routed to them; what experts held elsewhere add is not computed.
  No capacity limit, no dropped rows;
* the shared experts (one SwiGLU of ``n_shared · width``) run on every row.

The routed rows are ordered by a stable sort of the chosen ids, grouped by
held expert, each group padded to a multiple of ``ALIGN`` rows (padding
rows read row 0 at weight 0, so they add nothing forward or backward). The
groups' products are one grouped product of the held experts' stacked
weights (``torch._grouped_mm`` in bf16, where torch has it) or a loop over
them; the sizes of the groups are read on the host once a call. Their
backward is written out (:class:`_HeldExpertsFn`, :class:`_AddRows`): of
what grows with the routing it keeps the gate and up projections ``h``
(2·width bf16 a row, where autograd kept about five times the bytes: the
gathered rows, ``silu(g)``, ``silu(g)·u`` and two float32 copies of the
output), takes the rows again from the layer's input and ``silu(g)·u``
again from ``h``, and frees each temporary when it is spent; no product is
run twice. A step's held rows drift with training, and its peak memory
with them, by what each row keeps and the first backward's temporaries.

:func:`counts` gives what the layer routed since :func:`reset_counts`:
calls, rows routed to held experts, the most rows one held expert got in
one call, and the shape of the last call's held experts (how many, the
hidden and the expert width), from which a reader counts their work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_active_ai_tpu_torch.utils.profiling import span

ALIGN = 8
_COUNTS = {"calls": 0, "rows": 0, "max_expert_rows": 0, "held": 0, "hidden": 0, "width": 0}


def counts() -> dict[str, int]:
    """Calls of :class:`MoE`, rows routed to held experts, the largest held
    expert's rows in one call, and the last call's held experts, hidden
    width and expert width, since :func:`reset_counts`."""
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) · up(x))``, no biases (``DeepseekV3MLP``)."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False)
        self.up_proj = nn.Linear(hidden, width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Routing(NamedTuple):
    """One MoE call's routing: ``scores`` ``(T, E)`` float32 (``σ(W_r·x)``,
    with gradient), ``chosen`` ``(T, k)`` ids, ``load`` ``(E,)`` rows each
    expert was chosen for."""

    scores: torch.Tensor
    chosen: torch.Tensor
    load: torch.Tensor


class Router(nn.Module):
    """``MoEGate`` with ``scoring_func`` sigmoid and ``topk_method``
    noaux_tc: ``weight`` ``(E, d)``, buffer ``e_score_correction_bias``."""

    def __init__(self, hidden: int, experts: int, top_k: int, scaling: float):
        super().__init__()
        self.top_k, self.scaling = top_k, scaling
        self.weight = nn.Parameter(torch.empty(experts, hidden))
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(chosen (T, k), weights (T, k) float32, scores (T, E) float32)``."""
        with torch.autocast(x.device.type, enabled=False):
            scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        chosen = torch.topk(scores.detach() + self.e_score_correction_bias, self.top_k,
                            dim=-1, sorted=False).indices
        w = scores.gather(1, chosen)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return chosen, w * self.scaling, scores


class HeldExperts(nn.Module):
    """The held experts' SwiGLUs stacked: ``gate_up_proj`` ``(n, 2w, d)``
    (each expert's ``gate_proj`` rows over its ``up_proj`` rows) and
    ``down_proj`` ``(n, d, w)``."""

    def __init__(self, count: int, hidden: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(count, 2 * width, hidden))
        self.down_proj = nn.Parameter(torch.empty(count, hidden, width))

    def forward(self, x: torch.Tensor, rows: torch.Tensor, row_w: torch.Tensor,
                sizes: list[int], offs: torch.Tensor, grouped: bool | None = None
                ) -> torch.Tensor:
        """``(P, d)`` float32: ``row_w[j] · SwiGLU_e(x[rows[j]])`` for row
        ``j`` of the grouped buffer, group ``e`` of ``sizes[e]`` rows ending
        at ``offs[e]`` (int32, on the rows' device); ``grouped`` None picks
        the grouped product where it serves (:func:`grouped_available`)."""
        w1, w2 = self.gate_up_proj.to(x.dtype), self.down_proj.to(x.dtype)
        if grouped is None:
            grouped = grouped_available(x)
        return _HeldExpertsFn.apply(x, rows, row_w, w1, w2, sizes, offs, grouped)


def _rows_by(x, w, sizes, offs, grouped):
    """Group ``e``'s rows of ``x`` ``(P, k)`` times ``w[e]ᵀ``, ``w`` ``(n, m, k)``:
    ``(P, m)``."""
    if grouped:
        return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    return torch.cat([part @ w[e].T for e, part in enumerate(x.split(sizes))])


def _rows_by_t(x, w, sizes, offs, grouped):
    """Group ``e``'s rows of ``x`` ``(P, m)`` times ``w[e]``: ``(P, k)``."""
    if grouped:
        return torch._grouped_mm(x, w, offs=offs)
    return torch.cat([part @ w[e] for e, part in enumerate(x.split(sizes))])


def _outer(g, x, sizes, offs, grouped):
    """``g_eᵀ · x_e`` for each group ``e`` of rows of ``g`` ``(P, m)`` and
    ``x`` ``(P, k)``: ``(n, m, k)``."""
    if grouped:
        return torch._grouped_mm(g.t(), x, offs=offs)
    return torch.stack([a.T @ b for a, b in zip(g.split(sizes), x.split(sizes))])


class _HeldExpertsFn(torch.autograd.Function):
    """The held experts on their rows, each row at its weight, with the
    backward written out: ``h = x_rows·W1ᵀ`` (gate over up), ``a =
    silu(g)·u``, ``y = a·W2ᵀ``, out ``= y·w`` in float32. It keeps ``h``;
    ``x_rows`` is gathered again from ``x`` (kept anyway by the shared
    experts) and ``a`` recomputed from ``h``. The row weights' gradient is
    ``⟨∂out·W2, a⟩``, which is ``⟨∂out, y⟩`` without keeping ``y``. Each
    row's temporaries are freed as soon as they are spent: the first
    layer's backward holds them beside every layer's activations."""

    @staticmethod
    def forward(ctx, x, rows, row_w, w1, w2, sizes, offs, grouped):
        width = w2.shape[2]
        h = _rows_by(x.index_select(0, rows), w1, sizes, offs, grouped)
        y = _rows_by(F.silu(h[:, :width]) * h[:, width:], w2, sizes, offs, grouped)
        ctx.save_for_backward(x, rows, row_w, w1, w2, h, offs)
        ctx.sizes, ctx.grouped = sizes, grouped
        return y * row_w[:, None]

    @staticmethod
    def backward(ctx, grad):
        x, rows, row_w, w1, w2, h, offs = ctx.saved_tensors
        sizes, grouped, width = ctx.sizes, ctx.grouped, w2.shape[2]
        gate, up = h[:, :width], h[:, width:]
        dy = grad.to(h.dtype, copy=True)
        da = _rows_by_t(dy, w2, sizes, offs, grouped)
        a = F.silu(gate) * up
        d_row_w = (da * a).sum(-1, dtype=torch.promote_types(h.dtype, torch.float32))
        torch.mul(grad, row_w[:, None], out=dy)
        d_w2 = _outer(dy, a, sizes, offs, grouped)
        del dy, a
        torch.mul(da, row_w[:, None], out=da)
        dh = torch.cat([torch.ops.aten.silu_backward(da * up, gate), da * F.silu(gate)], -1)
        del da
        d_w1 = _outer(dh, x.index_select(0, rows), sizes, offs, grouped)
        dx = torch.zeros_like(x).index_add_(0, rows, _rows_by_t(dh, w1, sizes, offs, grouped))
        return dx, None, d_row_w, d_w1, d_w2, None, None, None


def grouped_available(rows: torch.Tensor) -> bool:
    """Whether ``torch._grouped_mm`` serves these rows: bf16, and on a card
    of compute capability 9.0 (Hopper) or the CPU."""
    if rows.dtype != torch.bfloat16 or not hasattr(torch, "_grouped_mm"):
        return False
    return rows.device.type == "cpu" or torch.cuda.get_device_capability(rows.device) == (9, 0)


class _AddRows(torch.autograd.Function):
    """``zeros(tokens, d).index_add(0, rows, y)``, whose backward gathers
    the gradient's rows; autograd's ``index_add`` would keep ``y`` (a
    float32 row of ``d`` a routed row) only for its shape."""

    @staticmethod
    def forward(ctx, y, rows, tokens):
        ctx.save_for_backward(rows)
        return y.new_zeros(tokens, y.shape[1]).index_add_(0, rows, y)

    @staticmethod
    def backward(ctx, grad):
        rows, = ctx.saved_tensors
        return grad.index_select(0, rows), None, None


class MoE(nn.Module):
    """``(B, L, d) → ((B, L, d), Routing)``. Submodules ``gate``,
    ``experts`` (the held ones) and ``shared_experts``; ``held`` is the
    range of expert ids this layer holds."""

    def __init__(self, hidden: int, experts: int, top_k: int, width: int, shared: int,
                 scaling: float, held: range):
        super().__init__()
        if not (0 <= held.start < held.stop <= experts and held.step == 1):
            raise ValueError(f"held experts {held} outside 0..{experts - 1}")
        self.held = held
        self.gate = Router(hidden, experts, top_k, scaling)
        self.experts = HeldExperts(len(held), hidden, width)
        self.shared_experts = SwiGLU(hidden, shared * width)
        self.grouped: bool | None = None

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, Routing]:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        dtype = torch.get_autocast_dtype(x.device.type) if torch.is_autocast_enabled(
            x.device.type) else x.dtype
        xc = x.to(dtype)
        with span("models.lm.moe.route"):
            chosen, weights, scores = self.gate(x)
            rows, row_w, sizes, offs, load = self._plan(chosen, weights)
        with span("models.lm.moe.experts"):
            y = self.experts(xc, rows, row_w, sizes, offs, self.grouped)
        with span("models.lm.moe.shared"):
            out = self.shared_experts(xc)
        with span("models.lm.moe.combine"):
            out = out + _AddRows.apply(y, rows, x.shape[0])
        return out.reshape(shape), Routing(scores, chosen, load)

    def _plan(self, chosen: torch.Tensor, weights: torch.Tensor):
        """The held experts' rows: token index and weight of each row of the
        grouped buffer (padding rows: token 0, weight 0), the padded group
        sizes and their ends, and every expert's load. The loads are read on
        the host once; the rest stays on the device."""
        k, dev = chosen.shape[1], chosen.device
        flat = chosen.flatten()
        load = torch.bincount(flat, minlength=self.gate.weight.shape[0])
        order = torch.argsort(flat, stable=True)
        per = load.tolist()
        lo, hi = self.held.start, self.held.stop
        held, start = per[lo:hi], sum(per[:lo])
        n, padded = sum(held), [-(-c // ALIGN) * ALIGN for c in held]
        sel = order[start:start + n]
        c = load[lo:hi]
        ends = c.cumsum(0)
        pad = (c + ALIGN - 1) // ALIGN * ALIGN
        offs = pad.cumsum(0)
        j = torch.arange(n, device=dev)
        group = torch.searchsorted(ends, j, right=True)
        dest = j + ((offs - pad) - (ends - c))[group]
        total = sum(padded)
        rows = torch.zeros(total, dtype=torch.long, device=dev).index_copy(0, dest, sel // k)
        row_w = torch.zeros(total, dtype=weights.dtype, device=dev).index_copy(
            0, dest, weights.flatten()[sel])
        _COUNTS["calls"] += 1
        _COUNTS["rows"] += n
        _COUNTS["max_expert_rows"] = max(_COUNTS["max_expert_rows"], max(held, default=0))
        w = self.experts.down_proj
        _COUNTS.update(held=w.shape[0], hidden=w.shape[1], width=w.shape[2])
        return rows, row_w, padded, offs.to(torch.int32), load


def sequence_balance_loss(r: Routing, batch: int) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance loss of one layer, before α:
    per sequence of ``T`` tokens ``Σᵢ fᵢ·Pᵢ`` with ``fᵢ = E/(k·T)·#{t : i
    chosen at t}`` and ``Pᵢ = mean_t s'ᵢ,ₜ``, ``s'`` the scores over every
    expert normalised to sum 1 a token; the mean over the ``batch``
    sequences."""
    tokens, experts = r.scores.shape
    t, k = tokens // batch, r.chosen.shape[1]
    hits = torch.zeros(batch, experts, device=r.scores.device).scatter_add_(
        1, r.chosen.reshape(batch, t * k), torch.ones(batch, t * k, device=r.scores.device))
    f = hits * (experts / (k * t))
    p = (r.scores / r.scores.sum(-1, keepdim=True)).reshape(batch, t, experts).mean(1)
    return (f * p).sum(-1).mean()


@torch.no_grad()
def update_bias(router: Router, load: torch.Tensor, gamma: float) -> None:
    """The auxiliary-loss-free rule after an update: ``bᵢ ← bᵢ +
    γ·sign(mean load − loadᵢ)`` over the step's routing."""
    load = load.float()
    router.e_score_correction_bias.add_(torch.sign(load.mean() - load), alpha=gamma)
