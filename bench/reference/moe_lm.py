"""The plain reference of the benchmark's MoE decoder configurations
(``"reference": "moe_lm"`` in ``bench/configs/*.json``): the weight
layout (:func:`shapes`), forward pass and next-token loss in plain
PyTorch float32, with no kernel, cache manager or batching of the
program under test.  Gradients come from autograd and the update from
``bench/reference/adamw.py``.

It follows the configuration file as the port runs it (the file's
``departures`` list where that differs from the published model): RMS
norms scaled by ``1 + scale``, per-head q/k RMS norms before the rotary
embedding (halves rotated), causal softmax attention, a float32 router
whose top-k gates are renormalised, and GShard capacity: per batch row,
assignments take expert slots in (token, k) order and those past
``capacity`` are dropped.

The model can follow a routing it is given (:attr:`Model.routes`): the
expert indices of each MoE call, in call order, in place of its own
top-k.  The training check gives it the program's: a float32 near-tie
in the router (two experts' probabilities within a rounding of each
other) is resolved either way by a sound program, and one token routed
otherwise changes later layers and every gradient, so the reference
follows the routing and judges it apart (:attr:`Model.route_gap`).

``tf32=True`` rounds both operands of every matrix product (forward and
backward) to TF32's 10-bit mantissa with float32 accumulation: the
nearest precision below the configuration's float32, used only as the
control that a sound comparison has to fail.

Imports torch alone: nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def capacity(tokens: int, cfg: dict) -> int:
    """Expert slots per batch row for a call over ``tokens`` tokens:
    ``capacity_factor * tokens * top_k / n_experts``, at least 8, rounded
    up to a multiple of 8."""
    c = int(cfg["capacity_factor"] * tokens * cfg["num_experts_per_tok"]
            / cfg["num_experts"])
    return max(8, -(-c // 8) * 8)


def shapes(cfg: dict) -> dict:
    """The parameter tree the port's decoder takes (``embed``, ``stack``
    with every per-layer tensor stacked over the layers, ``final_norm``,
    ``lm_head``): path -> (shape, std or 0.0 for zeros, dtype name).
    Norm scales start at zero, as ``1 + scale`` norms do."""
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    e, f, v = cfg["num_experts"], cfg["intermediate_size"], cfg["vocab_size"]
    dt = cfg["dtype"]
    s = lambda fan: 1.0 / math.sqrt(fan)
    return {
        ("embed", "table"): ((v, d), 0.02, dt),
        ("stack", "l0", "ln1", "scale"): ((n, d), 0.0, dt),
        ("stack", "l0", "ln2", "scale"): ((n, d), 0.0, dt),
        ("stack", "l0", "attn", "wq"): ((n, d, h, hd), s(d), dt),
        ("stack", "l0", "attn", "wk"): ((n, d, kvh, hd), s(d), dt),
        ("stack", "l0", "attn", "wv"): ((n, d, kvh, hd), s(d), dt),
        ("stack", "l0", "attn", "wo"): ((n, h, hd, d), s(h * hd), dt),
        ("stack", "l0", "attn", "q_norm"): ((n, hd), 0.0, dt),
        ("stack", "l0", "attn", "k_norm"): ((n, hd), 0.0, dt),
        ("stack", "l0", "moe", "router"): ((n, d, e), s(d), "float32"),
        ("stack", "l0", "moe", "wi"): ((n, e, d, f), s(d), dt),
        ("stack", "l0", "moe", "wg"): ((n, e, d, f), s(d), dt),
        ("stack", "l0", "moe", "wo"): ((n, e, f, d), s(f), dt),
        ("final_norm", "scale"): ((d,), 0.0, dt),
        ("lm_head", "w"): ((d, v), s(d), dt),
    }


def _round_tf32(t):
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_round_tf32(a), _round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return (torch.matmul(g, _round_tf32(b).mT),
                torch.matmul(_round_tf32(a).mT, g))


class Model:
    """The configuration's decoder over a parameter tree in the
    benchmark's layout (:func:`shapes`): per-layer tensors stacked over
    the layers."""

    def __init__(self, cfg: dict, params: dict, *, tf32: bool = False):
        self.cfg, self.p, self.tf32 = cfg, params, tf32
        self.L = cfg["num_hidden_layers"]
        self.H, self.KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.hd, self.D = cfg["head_dim"], cfg["hidden_size"]
        self.E, self.K = cfg["num_experts"], cfg["num_experts_per_tok"]
        self.eps = cfg["rms_norm_eps"]
        #: where set, expert indices (B, S, K) that the MoE calls take, in
        #: call order, in place of their own top-k
        self.routes: list | None = None
        #: the expert indices (B, S, K) each MoE call took, in call order
        self.taken: list = []
        #: over the followed calls' rows, the most by which the least
        #: probable expert taken lies below this model's own k-th
        #: probability (0 where a row takes this model's own top-k; 1, the
        #: most a probability can lie below another, where the routes do
        #: not cover the calls)
        self.route_gap = 0.0

    # -- primitives ----------------------------------------------------- #
    def mm(self, a, b):
        if self.tf32:
            return _TF32Matmul.apply(a, b)
        return torch.matmul(a, b)

    def norm(self, x, scale):
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return y if scale is None else y * (1.0 + scale)

    def rope(self, x, positions):
        """x (N, heads, hd) at ``positions`` (N,)."""
        half = self.hd // 2
        freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                        device=x.device)
                          * (math.log(self.cfg["rope_theta"]) / half))
        ang = positions[:, None].float() * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def layer(self, i: int):
        return {k: {n: t[i] for n, t in v.items()}
                for k, v in self.p["stack"]["l0"].items()}

    # -- blocks --------------------------------------------------------- #
    def qkv(self, lp, h, positions):
        """h (N, D) -> q (N, H, hd), k and v (N, KH, hd)."""
        a = lp["attn"]
        N = h.shape[0]
        q = self.mm(h, a["wq"].reshape(self.D, -1)).view(N, self.H, self.hd)
        k = self.mm(h, a["wk"].reshape(self.D, -1)).view(N, self.KH, self.hd)
        v = self.mm(h, a["wv"].reshape(self.D, -1)).view(N, self.KH, self.hd)
        q = self.rope(self.norm(q, a["q_norm"]), positions)
        k = self.rope(self.norm(k, a["k_norm"]), positions)
        return q, k, v

    def attend(self, q, k, v, q_pos, k_pos):
        """q (B, S, H, hd) over k/v (B, T, KH, hd); query at q_pos (S,)
        sees keys at k_pos (T,) <= its own -> (B, S, H * hd)."""
        B, S = q.shape[:2]
        T = k.shape[1]
        g = self.H // self.KH
        k = k.repeat_interleave(g, 2) if g > 1 else k
        v = v.repeat_interleave(g, 2) if g > 1 else v
        qh = q.permute(0, 2, 1, 3).reshape(B * self.H, S, self.hd)
        kh = k.permute(0, 2, 3, 1).reshape(B * self.H, self.hd, T)
        vh = v.permute(0, 2, 1, 3).reshape(B * self.H, T, self.hd)
        s = self.mm(qh, kh) / math.sqrt(self.hd)
        mask = k_pos[None, :] > q_pos[:, None]
        s = s.masked_fill(mask, float("-inf"))
        o = self.mm(torch.softmax(s, -1), vh)
        return o.view(B, self.H, S, self.hd).permute(0, 2, 1, 3).reshape(
            B, S, self.H * self.hd)

    def moe(self, mp, x, cap):
        """x (B, S, D) -> (y (B, S, D), aux).  Each batch row is a group;
        ``cap`` None keeps every assignment."""
        B, S, D = x.shape
        E, K = self.E, self.K
        x2 = x.reshape(B * S, D)
        probs = torch.softmax(self.mm(x2, mp["router"]), -1)
        n = len(self.taken)
        given = (self.routes[n] if self.routes is not None
                 and n < len(self.routes) else None)
        if given is not None and tuple(given.shape) == (B, S, K):
            ei = given.reshape(B * S, K).to(x.device)
            gv = probs.gather(1, ei)
            kth = torch.topk(probs.detach(), K, dim=-1).values[:, -1]
            self.route_gap = max(self.route_gap, float(
                (kth - gv.detach().min(-1).values).max()))
        else:
            if self.routes is not None:
                self.route_gap = 1.0
            gv, ei = torch.topk(probs, K, dim=-1)
        self.taken.append(ei.detach().reshape(B, S, K))
        gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
        keep = torch.ones_like(ei, dtype=torch.bool)
        if cap is not None:
            oh = F.one_hot(ei.reshape(B, S * K), E)
            pos = ((torch.cumsum(oh, 1) - oh) * oh).sum(-1)
            keep = (pos < cap).reshape(B * S, K)
        flat_e = ei.reshape(-1)[keep.reshape(-1)]
        flat_t = torch.arange(B * S, device=x.device).repeat_interleave(K)[
            keep.reshape(-1)]
        flat_w = gv.reshape(-1)[keep.reshape(-1)]
        order = torch.argsort(flat_e, stable=True)
        counts = torch.bincount(flat_e, minlength=E).tolist()
        y = torch.zeros_like(x2)
        start = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            sel = order[start:start + n]
            start += n
            tok = flat_t[sel]
            xe = x2[tok]
            h = self.mm(xe, mp["wi"][e])
            gt = self.mm(xe, mp["wg"][e])
            o = self.mm(F.silu(gt) * h, mp["wo"][e])
            y = y.index_add(0, tok, o * flat_w[sel, None])
        frac_tokens = F.one_hot(ei, E).sum(1).float().mean(0)
        aux = E * torch.sum(frac_tokens * probs.mean(0)) / K
        return y.view(B, S, D), aux

    def logits(self, h):
        return self.mm(self.norm(h, self.p["final_norm"]["scale"]),
                       self.p["lm_head"]["w"])

    # -- training ------------------------------------------------------- #
    def loss(self, tokens):
        """Next-token loss of tokens (B, S) with the z-loss and the MoE
        load-balancing loss, as the configuration states."""
        B, S = tokens.shape
        x = self.p["embed"]["table"][tokens]
        pos = torch.arange(S, device=tokens.device)
        cap = capacity(S, self.cfg)
        aux = torch.zeros((), device=tokens.device)
        for i in range(self.L):
            lp = self.layer(i)
            h = self.norm(x, lp["ln1"]["scale"]).reshape(B * S, self.D)
            q, k, v = self.qkv(lp, h, pos.repeat(B))
            o = self.attend(q.view(B, S, self.H, self.hd),
                            k.view(B, S, self.KH, self.hd),
                            v.view(B, S, self.KH, self.hd), pos, pos)
            x = x + self.mm(o, lp["attn"]["wo"].reshape(-1, self.D))
            y, a = self.moe(lp["moe"], self.norm(x, lp["ln2"]["scale"]), cap)
            x, aux = x + y, aux + a
        lf = self.logits(x[:, :-1].reshape(-1, self.D))
        lse = torch.logsumexp(lf, -1)
        gold = lf.gather(-1, tokens[:, 1:].reshape(-1, 1))[:, 0]
        return ((lse - gold).mean() + self.cfg["z_loss_coef"]
                * lse.square().mean()
                + self.cfg["router_aux_loss_coef"] * aux)
