"""The plain float32 reference of the decoders the benchmark runs.

Plain PyTorch over a state dict in the port's naming (``embed.tok``,
``decoder.layers.{i}.{ssm|attn|ffn|moe}.<leaf>``, ``decoder.norm``,
``lm_head``). It imports nothing of the program: a family's file
(``ssm.py``, ``hybrid.py``) only says which layer kinds come where, and
everything is worked out here again from the configuration file and the
weights that the benchmark made, in float32 with TF32 off. Weights stay
in the type they were made in and are upcast one matrix at a time as
they are used, so that the reference fits beside a model's bf16 weights.

The model, as the port defines it:

* the embedding times sqrt(d_model); each layer ``x += mixer(norm(x))``
  then ``x += ffn(norm(x))`` (no FFN where the configuration has none);
  the final norm, then the tied embedding or ``lm_head``;
* RMSNorm scales by ``1 + scale`` (the scale is stored zero-centred);
* Mamba-2 (arXiv:2405.21060): in-projection to z, x, B, C and dt; a
  depthwise causal convolution and SiLU over x, B and C; dt through
  softplus with its bias; A = -exp(A_log); the SSD recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t + D x_t;
  RMSNorm of y·SiLU(z); out-projection;
* attention: fused q, k, v projection, rotary embedding of split halves
  when ``rope_theta > 0``, grouped heads, the causal mask (and the window
  where there is one), softmax in float32;
* the gated SiLU FFN (or tanh GELU where ``ffn_gated`` is false);
* the MoE: a float32 router, softmax, the top-k experts by a stable sort
  (a tie goes to the lower index) renormalised, and each expert's
  capacity ceil(T·k/E·capacity_factor) rounded up to 8, at least 8, over
  the T tokens dispatched together: an expert takes its assignments in
  token-major order and drops those past its capacity.

``precision="fp8"`` is the control: every matrix product but the router's
takes its operands rounded to float8 e4m3 (a scale for each row of the
activations and each column of the weights), as a port that dropped to
fp8 would. Gradients pass the rounding unchanged.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0
NEG = -1e30
# tokens of a prefill that the reference's mixers and FFNs take at a time
PREFILL_TOKENS = 8192


@contextlib.contextmanager
def ieee_f32():
    """float32 products without TF32 inside the block."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = prev


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) \
        / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return t + (q - t).detach()


class Ops:
    """The products and the weights' upcast of one precision."""

    def __init__(self, weights: Dict[str, torch.Tensor], precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision is f32 or fp8, not {precision!r}")
        self.w, self.fp8 = weights, precision == "fp8"

    def p(self, name: str) -> torch.Tensor:
        return self.w[name].to(F32)

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a [..., k] @ w [k, n] in float32 (operands rounded to fp8 for
        the control)."""
        w = w.to(F32)
        if self.fp8:
            a, w = _fp8(a, -1), _fp8(w, -2)
        return a @ w


# ---------------------------------------------------------------- pieces --
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.to(F32))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, L, n, h] at positions ``pos`` [L]: the two halves of the head
    rotated by pos / theta^(2i/h)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def ffn(ops: Ops, pre: str, x: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:
        h = F.silu(ops.mm(x, ops.w[pre + "wg"])) * ops.mm(x, ops.w[pre + "wu"])
    else:
        h = F.gelu(ops.mm(x, ops.w[pre + "wu"]), approximate="tanh")
    return ops.mm(h, ops.w[pre + "wd"])


def capacity(T: int, k: int, E: int, factor: float) -> int:
    c = math.ceil(T * k / E * factor)
    return max(8, -(-c // 8) * 8)


def moe(ops: Ops, pre: str, x: torch.Tensor, m: Dict
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] dispatched together -> (y [T, d], Switch aux loss)."""
    T = x.shape[0]
    E, k = m["n_experts"], m["top_k"]
    logits = x @ ops.p(pre + "router")           # the router stays f32
    probs = torch.softmax(logits, -1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(T, k, E, m.get("capacity_factor", 1.25))
    flat_e, flat_w = top_i.reshape(-1), top_p.reshape(-1)
    y = torch.zeros_like(x)
    for e in range(E):
        sel = torch.nonzero(flat_e == e).flatten()[:cap]
        if sel.numel() == 0:
            continue
        tok = sel // k
        h = x[tok]
        gated = m.get("_gated", True)
        if gated:
            h = F.silu(ops.mm(h, ops.w[pre + "wg"][e])) \
                * ops.mm(h, ops.w[pre + "wu"][e])
        else:
            h = F.gelu(ops.mm(h, ops.w[pre + "wu"][e]), approximate="tanh")
        y.index_add_(0, tok, ops.mm(h, ops.w[pre + "wd"][e])
                     * flat_w[sel][:, None])
    if m.get("n_shared_experts"):
        y = y + ffn(ops, pre + "shared_", x, m.get("_gated", True))
    if m.get("dense_residual"):
        y = y + ffn(ops, pre + "dense_", x, m.get("_gated", True))
    top1 = torch.bincount(top_i[:, 0], minlength=E).to(F32) / T
    aux = E * torch.sum(probs.mean(0) * top1)
    return y, aux


# ------------------------------------------------------------------ SSD ---
def ssd(x, dt, A, Bm, Cm, h0, chunk: int = 64):
    """The SSD recurrence over x [b, L, nh, hd], dt [b, L, nh], A [nh],
    Bm/Cm [b, L, G, N] from the state h0 [b, nh, hd, N], chunk by chunk
    (each chunk in closed form, the state carried between chunks) ->
    (y [b, L, nh, hd], the state after the last position)."""
    b, L, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = nh // G
    hsel = torch.arange(nh, device=x.device) // rep      # head -> group
    h = h0
    ys = []
    for c0 in range(0, L, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bc, Cc = Bm[:, c0:c0 + chunk][:, :, hsel], Cm[:, c0:c0 + chunk][:, :, hsel]
        Q = xc.shape[1]
        cs = torch.cumsum(dtc * A, dim=1)                 # [b, Q, nh]
        diff = cs[:, :, None, :] - cs[:, None, :, :]      # [b, i, j, nh]
        mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~mask[None, :, :, None], NEG))
        cb = torch.einsum("bihn,bjhn->bijh", Cc, Bc)
        wgt = cb * decay * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", wgt, xc)
        y = y + torch.einsum("bihn,bhpn->bihp", Cc, h) \
            * torch.exp(cs)[..., None]
        last = cs[:, -1:, :]                              # [b, 1, nh]
        carry = torch.exp(last - cs) * dtc                # [b, Q, nh]
        h = h * torch.exp(last[:, 0])[:, :, None, None] \
            + torch.einsum("bjh,bjhp,bjhn->bhpn", carry, xc, Bc)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba(ops: Ops, pre: str, x: torch.Tensor, s: Dict, d: int, eps: float,
          state: Optional[Dict[str, torch.Tensor]] = None
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [b, L, d] (after the layer's norm), continuing ``state`` ({"conv":
    the last width-1 conv inputs, "h"}) or from zero -> (out, new state)."""
    b, L, _ = x.shape
    d_in = s["expand"] * d
    nh, hd = d_in // s["headdim"], s["headdim"]
    G, N, w = s.get("n_groups", 1), s["d_state"], s["conv_width"]
    C = d_in + 2 * G * N
    zxbcdt = ops.mm(x, ops.w[pre + "in_proj"])
    z, xbc, dt = zxbcdt.split([d_in, C, nh], dim=-1)
    dt = F.softplus(dt + ops.p(pre + "dt_bias"))
    A = -torch.exp(ops.p(pre + "A_log"))
    hist = (torch.zeros(b, w - 1, C, dtype=F32, device=x.device)
            if state is None else state["conv"])
    full = torch.cat([hist, xbc], dim=1)                  # [b, w-1+L, C]
    conv = F.conv1d(full.transpose(1, 2), ops.p(pre + "conv").t()[:, None, :],
                    groups=C).transpose(1, 2)             # [b, L, C]
    xbc = F.silu(conv)
    xs, Bm, Cm = xbc.split([d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(b, L, nh, hd)
    h0 = (torch.zeros(b, nh, hd, N, dtype=F32, device=x.device)
          if state is None else state["h"])
    y, h = ssd(xs, dt, A, Bm.reshape(b, L, G, N), Cm.reshape(b, L, G, N), h0)
    y = y + xs * ops.p(pre + "D")[None, None, :, None]
    y = rms_norm(y.reshape(b, L, d_in) * F.silu(z), ops.p(pre + "gate_norm"),
                 eps)
    return ops.mm(y, ops.w[pre + "out_proj"]), {"conv": full[:, -(w - 1):],
                                                "h": h}


def attention(ops: Ops, pre: str, x: torch.Tensor, m: Dict, window,
              state: Optional[Dict[str, torch.Tensor]] = None, pos0: int = 0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [b, L, d] at positions pos0.. over the keys in ``state`` and its
    own -> (out, state with its keys and values appended)."""
    b, L, d = x.shape
    nq, nkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("d_head") or d // nq
    qkv = ops.mm(x, ops.w[pre + "wqkv"])
    if pre + "bqkv" in ops.w:
        qkv = qkv + ops.p(pre + "bqkv")
    q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
    q, k, v = (q.reshape(b, L, nq, hd), k.reshape(b, L, nkv, hd),
               v.reshape(b, L, nkv, hd))
    pos = pos0 + torch.arange(L, device=x.device)
    if m.get("rope_theta", 0) > 0:
        q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    if state is not None:
        k, v = torch.cat([state["k"], k], 1), torch.cat([state["v"], v], 1)
    kpos = torch.arange(k.shape[1], device=x.device)
    g = nq // nkv
    kh = k.repeat_interleave(g, dim=2)                    # [b, S, nq, hd]
    vh = v.repeat_interleave(g, dim=2)
    out = torch.empty(b, L, nq, hd, dtype=F32, device=x.device)
    for r in range(b):                                    # rows, then
        for q0 in range(0, L, 1024):                      # query blocks
            qb = q[r, q0:q0 + 1024]                       # [l, nq, hd]
            s = torch.einsum("lhd,shd->hls", qb, kh[r]) / math.sqrt(hd)
            qp = pos[q0:q0 + 1024][:, None]
            ok = kpos[None, :] <= qp
            if window is not None:
                ok = ok & ((qp - kpos[None, :]) < window)
            s = s.masked_fill(~ok[None], NEG)
            out[r, q0:q0 + 1024] = torch.einsum(
                "hls,shd->lhd", torch.softmax(s, -1), vh[r])
    return ops.mm(out.reshape(b, L, nq * hd), ops.w[pre + "wo"]), \
        {"k": k, "v": v}


# --------------------------------------------------------------- layers ---
Kinds = Sequence[Tuple[str, Optional[str], bool]]   # (mixer, ffn, global)


def layer(ops: Ops, m: Dict, kinds: Kinds, i: int, x: torch.Tensor,
          state=None, pos0: int = 0, rows: int = 0):
    """Layer ``i``: x [b, L, d] -> (x, mixer state, MoE aux or None). The
    MoE dispatches the b·L tokens of the pass together. ``rows`` > 0 runs
    the mixer ``rows`` rows at a time and the dense FFN on as many tokens
    at a time (the same function, in less memory)."""
    mixer, ff, is_global = kinds[i]
    pre = f"decoder.layers.{i}."
    eps = m.get("norm_eps", 1e-6)
    b, L, d = x.shape
    if mixer == "ssm":
        def mix(h, st):
            return mamba(ops, pre + "ssm.", h, m["ssm"], d, eps, st)
        ln = pre + "ssm.ln"
    else:
        win = None if is_global else m.get("sliding_window")

        def mix(h, st):
            return attention(ops, pre + "attn.", h, m, win, st, pos0)
        ln = pre + "attn.ln"
    h = rms_norm(x, ops.w[ln], eps)
    step = rows or b
    parts = [mix(h[r:r + step], None if state is None else
                 {k: v[r:r + step] for k, v in state.items()})
             for r in range(0, b, step)]
    x = x + torch.cat([o for o, _ in parts])
    st = {k: torch.cat([s_[k] for _, s_ in parts]) for k in parts[0][1]}
    del parts, h
    aux = None
    if ff == "ffn":
        h = rms_norm(x, ops.w[pre + "ffn.ln"], eps).reshape(b * L, d)
        tok = rows * L if rows else b * L
        y = torch.cat([ffn(ops, pre + "ffn.", h[t:t + tok],
                           m.get("ffn_gated", True))
                       for t in range(0, b * L, tok)])
        x = x + y.reshape(b, L, d)
    elif ff == "moe":
        h = rms_norm(x, ops.w[pre + "moe.ln"], eps).reshape(b * L, d)
        y, aux = moe(ops, pre + "moe.", h,
                     dict(m["moe"], _gated=m.get("ffn_gated", True)))
        x = x + y.reshape(b, L, d)
    return x, st, aux


def embed(ops: Ops, m: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return ops.p("embed.tok")[tokens.long()] * math.sqrt(m["d_model"])


def logits(ops: Ops, m: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and unembedding of x [..., d] -> [..., V]."""
    x = rms_norm(x, ops.w["decoder.norm"], m.get("norm_eps", 1e-6))
    w = ops.w["embed.tok"].t() if m.get("tie_embeddings") else \
        ops.w["lm_head"]
    return ops.mm(x, w)


# -------------------------------------------------------------- training --
def loss(ops: Ops, m: Dict, kinds: Kinds, tokens, targets,
         xent_rows: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy (plus the MoE aux loss times its
    weight), every layer and every block of rows of the cross-entropy
    recomputed in the backward pass, so that it fits."""
    x = embed(ops, m, tokens)
    aux_sum = None
    for i in range(len(kinds)):
        x, aux = checkpoint(lambda x_, i_=i: _train_layer(ops, m, kinds, i_,
                                                          x_),
                            x, use_reentrant=False)
        if not torch.isnan(aux):
            aux_sum = aux if aux_sum is None else aux_sum + aux
    b, L, d = x.shape
    xf, tf = x.reshape(b * L, d), targets.reshape(-1).long()
    tot = torch.zeros((), dtype=F32, device=x.device)
    for r in range(0, b * L, xent_rows):
        tot = tot + checkpoint(_xent, ops, m, xf[r:r + xent_rows],
                               tf[r:r + xent_rows], use_reentrant=False)
    out = tot / (b * L)
    if aux_sum is not None:
        out = out + m["moe"].get("aux_loss_weight", 0.01) * aux_sum
    return out


def _train_layer(ops, m, kinds, i, x):
    x, _, aux = layer(ops, m, kinds, i, x)
    return x, (aux if aux is not None
               else torch.tensor(float("nan"), device=x.device))


def _xent(ops, m, x, t):
    lg = logits(ops, m, x)
    return (torch.logsumexp(lg, -1)
            - lg.gather(-1, t[:, None])[:, 0]).sum()


def lr_at(step: int, run: Dict) -> float:
    """Linear warm-up, then cosine decay to a tenth, at update ``step``
    (counted from 0)."""
    warm = min(1.0, (step + 1) / max(run["warmup_steps"], 1))
    span = max(run["total_steps"] - run["warmup_steps"], 1)
    prog = min(max((step - run["warmup_steps"]) / span, 0.0), 1.0)
    return run["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def decays(name: str, t: torch.Tensor) -> bool:
    """Weight decay applies to every leaf of a decoder layer and to the
    other leaves of two or more dimensions (the port's rule, after the
    JAX package's stacked layers)."""
    return name.startswith("decoder.layers.") or t.dim() >= 2


def train_follow(weights: Dict[str, torch.Tensor], m: Dict, kinds: Kinds,
                 run: Dict, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                 precision: str = "f32") -> Dict:
    """AdamW from ``weights`` over ``batches`` (one update each), in
    float32. Returns each step's loss, each leaf's norm of the first
    gradient as the optimizer takes it (clipped), and each leaf's norm of
    the change after the last step."""
    with ieee_f32():
        p0 = {k: v.to(F32) for k, v in weights.items()}
        params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        mom = {k: torch.zeros_like(v) for k, v in p0.items()}
        vel = {k: torch.zeros_like(v) for k, v in p0.items()}
        b1, b2, eps = run["beta1"], run["beta2"], 1e-8
        out: Dict = {"loss": [], "grad1": {}, "change": {}}
        names = list(params)
        for step, (tok, tgt) in enumerate(batches):
            ops = Ops(params, precision)
            lval = loss(ops, m, kinds, tok, tgt)
            grads = torch.autograd.grad(lval, [params[k] for k in names])
            out["loss"].append(float(lval.detach()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
                scale = (torch.clamp(run["grad_clip"] / (gnorm + 1e-9), max=1.0)
                         if run["grad_clip"] > 0 else torch.ones_like(gnorm))
                lr = lr_at(step, run)
                c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                for k, g in zip(names, grads):
                    g = g * scale
                    if step == 0:
                        out["grad1"][k] = float(g.norm())
                    mom[k].mul_(b1).add_(g, alpha=1 - b1)
                    vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    wd = run["weight_decay"] if decays(k, p0[k]) else 0.0
                    upd = (mom[k] / c1) / (torch.sqrt(vel[k] / c2) + eps) \
                        + wd * params[k]
                    params[k].sub_(lr * upd)
            del grads
        with torch.no_grad():
            out["change"] = {k: float((params[k] - p0[k]).norm())
                             for k in names}
    return out


# --------------------------------------------------------------- serving --
def serve_follow(weights: Dict[str, torch.Tensor], m: Dict, kinds: Kinds,
                 prompts: torch.Tensor, served: List[List[int]],
                 precision: str = "f32", judge: Optional[Dict] = None
                 ) -> Dict:
    """One static batch served as the port's ``Server`` serves it: the
    prompts [b, S] (right-padded with token 0 to the batch's longest) as
    one pass, then one position at a time for every row, each pass's MoE
    tokens dispatched together. Row j is fed its served tokens while it
    has them, then the reference's own greedy choice (its request is
    done, but the row still takes part in the batch).

    Returns, for every served token, its logit's gap below the best logit
    at that position, over the standard deviation of that position's
    logits: ``{"gaps": [[...] per row]}``. With ``judge`` (the float32
    run's ``{"inputs", "logits"}``), the run is fed ``judge["inputs"]``
    and the gap is read of the token that this run puts first, in the
    float32 run's logits (the control). Without it the run also returns
    the ``inputs`` it fed and its ``logits``."""
    b, S = prompts.shape
    steps = max(len(s) for s in served)
    dev = prompts.device
    with ieee_f32(), torch.no_grad():
        ops = Ops(weights, precision)
        states: List = [None] * len(kinds)
        x = embed(ops, m, prompts)
        rows = max(1, PREFILL_TOKENS // S)
        for i in range(len(kinds)):
            x, states[i], _ = layer(ops, m, kinds, i, x, rows=rows)
        lg = logits(ops, m, x[:, -1])
        gaps: List[List[float]] = [[] for _ in range(b)]
        inputs, lgs = [], []
        for t in range(steps):
            if judge is None:
                lgs.append(lg)
                best = lg.argmax(-1)
                feed = torch.tensor(
                    [s[t] if t < len(s) else int(best[j])
                     for j, s in enumerate(served)], device=dev)
                ref = lg
                pick = feed
            else:
                ref = judge["logits"][t]
                pick = lg.argmax(-1)
                feed = judge["inputs"][t]
            gap = (ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]) \
                / ref.std(-1)
            for j in range(b):
                if t < len(served[j]):
                    gaps[j].append(float(gap[j]))
            inputs.append(feed)
            if t == steps - 1:
                break
            x = embed(ops, m, feed[:, None])
            for i in range(len(kinds)):
                x, states[i], _ = layer(ops, m, kinds, i, x, states[i],
                                        pos0=S + t)
            lg = logits(ops, m, x[:, -1])
    out = {"gaps": gaps}
    if judge is None:
        out.update(inputs=inputs, logits=lgs)
    return out
