"""The plain reference of the LM cells: DeepSeek-V2's block (MLA with YaRN,
a dense first layer, then MoE layers of routed and shared experts) in
plain PyTorch, float32, from the published configuration's own keys
(``portbench/configs/<config>.json``).  It imports no kernel and no model
code of the port, and neither JAX nor the JAX package.

It takes the port's param tree as data (its keys and stacked layer axes:
``embed``, ``head_blocks``, ``stack``, ``ln_f``, ``lm_head``) and computes
the training loss and its gradients as the published model defines them,
with these departures, each shared with the port:

  - RoPE pairs the rope half's dims as its two halves, where the published
    code interleaves them: with random weights a fixed permutation of the
    rope columns of ``wq`` and ``wdkv``;
  - the auxiliary loss is the Switch form (``E * sum_e P_e * f_e``, f_e the
    top-1 share, over the whole batch) at 0.01, where the published model
    uses a sequence-wise balance loss;
  - a card's share of the experts: the router scores all of them, and only
    the held experts' part of each MoE layer's output is computed (what
    the absent experts add is left out, as on their card it is added by
    their holders);
  - the vocabulary is the configuration's slice.

``adamw`` is the optimizer step the trainer takes, as plainly.

Everything is computed in blocks of whole sequences, so the reference
fits beside the program's kept outputs: a first pass without gradients
counts the top-1 routing of the whole batch (the aux loss's f_e), and a
second pass takes each block's part of the loss and adds its gradients.
``Precision`` rounds the operands of every product for the controls.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

AUX_COEF = 0.01


class Precision:
    """The rounding applied to both operands of every product: none
    (float32), bfloat16, or float8 e4m3 with a per-tensor scale (as fp8
    training scales its operands)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        if self.name == "bfloat16":
            return t.to(torch.bfloat16).float()
        s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)


F32 = Precision()


def yarn_inv_freq(c: dict, device=None) -> Tuple[torch.Tensor, float]:
    """The rope half's inverse frequencies and cos/sin factor: plain RoPE,
    or YaRN's (``DeepseekV2YarnRotaryEmbedding``)."""
    d, base = c["qk_rope_head_dim"], float(c["rope_theta"])
    i2 = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    extra = 1.0 / base ** (i2 / d)
    y = c.get("rope_scaling")
    if not y:
        return extra, 1.0
    factor = float(y["factor"])
    inter = 1.0 / (factor * base ** (i2 / d))

    def dim_at(rot):
        return (d * math.log(y["original_max_position_embeddings"]
                             / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(dim_at(y["beta_fast"])), 0)
    high = min(math.ceil(dim_at(y["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    return inv, mscale(factor, y["mscale"]) / mscale(factor,
                                                      y["mscale_all_dim"])


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(c: dict) -> float:
    s = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    y = c.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        s *= mscale(float(y["factor"]), y["mscale_all_dim"]) ** 2
    return s


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, inv_freq, factor):
    """x [B, S, ..., d]: the two halves of d rotated as pairs."""
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv_freq
    shape = (1, S) + (1,) * (x.dim() - 3) + (-1,)
    cos = (torch.cos(ang) * factor).reshape(shape)
    sin = (torch.sin(ang) * factor).reshape(shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def mla(p, h, c, pr: Precision, q_block: int = 512):
    """Multi-head latent attention, training form, causal."""
    B, S, D = h.shape
    H = c["num_attention_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    L = c["kv_lora_rank"]
    inv, factor = yarn_inv_freq(c, h.device)
    q = pr.mm(h, p["wq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], inv, factor)
    dkv = pr.mm(h, p["wdkv"])
    ckv = rmsnorm(dkv[..., :L], p["kv_norm"], c["rms_norm_eps"])
    k_rope = rope(dkv[..., L:], inv, factor)                   # [B, S, dr]
    k_nope = pr.mm(ckv, p["wuk"]).reshape(B, S, H, dn)
    v = pr.mm(ckv, p["wuv"]).reshape(B, S, H, dv)
    scale = softmax_scale(c)
    outs = []
    for q0 in range(0, S, q_block):
        q1 = min(q0 + q_block, S)
        s = (torch.einsum("bqhn,bkhn->bhqk", pr(q_nope[:, q0:q1]),
                          pr(k_nope[:, :q1]))
             + torch.einsum("bqhr,bkr->bhqk", pr(q_rope[:, q0:q1]),
                            pr(k_rope[:, :q1]))) * scale
        causal = (torch.arange(q1, device=h.device)[None, :]
                  <= torch.arange(q0, q1, device=h.device)[:, None])
        w = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        outs.append(torch.einsum("bhqk,bkhv->bqhv", pr(w), pr(v[:, :q1])))
    o = torch.cat(outs, 1).reshape(B, S, H * dv)
    return pr.mm(o, p["wo"])


def mlp(p, h, pr: Precision):
    return pr.mm(F.silu(pr.mm(h, p["wg"])) * pr.mm(h, p["wi"]), p["wo"])


def moe(p, h, c, pr: Precision, model_index: int, ids=None):
    """The held experts' part of the MoE layer's output, plus the shared
    experts'; returns (y, the gates' sum over tokens [E], the top-1
    counts [E], the chosen experts [B * S, k]).  With ``ids`` the tokens
    go to those experts, in that order, in place of the router's top k."""
    B, S, D = h.shape
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    x = h.reshape(B * S, D)
    gates = torch.softmax(x @ p["wr"], -1)          # the router in float32
    if ids is None:
        w, ids = torch.topk(gates, k, dim=-1)
    else:
        ids = ids.reshape(B * S, k).to(x.device).long()
        w = gates.gather(-1, ids)
    if c["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    w = w * c["routed_scaling_factor"]
    held = p["wi"].shape[0]
    y = torch.zeros_like(x)
    for j in range(held):
        tok, slot = torch.nonzero(ids == model_index * held + j,
                                  as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        out = pr.mm(F.silu(pr.mm(xe, p["wg"][j])) * pr.mm(xe, p["wi"][j]),
                    p["wo"][j])
        y = y.index_add(0, tok, out * w[tok, slot][:, None])
    y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + mlp(p["shared"], h, pr)
    top1 = torch.bincount(ids[:, 0], minlength=E).float()
    return y, gates.sum(0), top1, ids


def layers(params) -> List[Tuple[dict, bool]]:
    """(layer params, is MoE) in order: the dense head blocks, then the
    stacked layers unstacked."""
    out = [(lp, False) for lp in params.get("head_blocks", [])]
    stack = params["stack"]
    n = next(iter(_leaves(stack)))[1].shape[0]
    for i in range(n):
        out.append((_map(lambda t: t[i], stack), "moe" in stack))
    return out


def forward(params, tokens, c, pr: Precision = F32, model_index: int = 0,
            routes=None):
    """Logits [B, S, V] and, per MoE layer, (gates' sum [E], top-1 counts
    [E], chosen experts [B * S, k]); ``routes``, per MoE layer the
    experts [B, S, k] to send the tokens to (``moe``'s ``ids``)."""
    eps = c["rms_norm_eps"]
    x = F.embedding(tokens.long(), params["embed"])
    routing = []
    for lp, is_moe in layers(params):
        x = x + mla(lp["attn"], rmsnorm(x, lp["ln1"]["w"], eps), c, pr)
        h = rmsnorm(x, lp["ln2"]["w"], eps)
        if is_moe:
            f, gsum, top1, ids = moe(
                lp["moe"], h, c, pr, model_index,
                None if routes is None else routes[len(routing)])
            routing.append((gsum, top1, ids))
        else:
            f = mlp(lp["mlp"], h, pr)
        x = x + f
    x = rmsnorm(x, params["ln_f"]["w"], eps)
    return pr.mm(x, params["lm_head"]), routing


def loss_and_grads(params, tokens: torch.Tensor, labels: torch.Tensor,
                   c: dict, *, precision: str = "float32",
                   model_index: int = 0, block: int = 1,
                   grads: bool = True, routes=None, own=None):
    """The training loss (mean cross-entropy + 0.01 x the Switch aux loss)
    and its gradients, a dict path -> float32 tensor of each leaf (None
    without ``grads``), from ``params`` (any float dtype; taken as
    float32), over ``block`` sequences at a time.  ``routes`` (per MoE
    layer the experts [B, S, k]) sends the tokens where they say in place
    of the router's top k; a list ``own`` gets the router's own choices,
    per MoE layer [B * S, k].  TF32 is turned off while it runs."""
    pr = Precision(precision)
    flat = {path: leaf.detach().float().requires_grad_(grads)
            for path, leaf in _leaves(params)}
    tree = _unflatten(params, flat)
    B, S = tokens.shape
    n_tok = B * S
    E = c["n_routed_experts"]

    def cut(b0):
        return None if routes is None else [r[b0:b0 + block]
                                            for r in routes]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():                     # the aux loss's f_e
            top1, mine = None, []
            for b0 in range(0, B, block):
                _, routing = forward(tree, tokens[b0:b0 + block], c, pr,
                                     model_index, cut(b0))
                t = torch.stack([r[1] for r in routing]) if routing else None
                top1 = t if top1 is None else top1 + t
                if own is not None:
                    if routes is not None:
                        routing = forward(tree, tokens[b0:b0 + block], c,
                                          pr, model_index)[1]
                    mine.append([r[2] for r in routing])
            share = None if top1 is None else top1 / n_tok
        loss = 0.0
        for b0 in range(0, B, block):
            with torch.set_grad_enabled(grads):
                logits, routing = forward(tree, tokens[b0:b0 + block], c,
                                          pr, model_index, cut(b0))
            part = F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                labels[b0:b0 + block].reshape(-1).long(),
                reduction="sum") / n_tok
            for li, (gsum, _, _) in enumerate(routing):
                part = part + AUX_COEF * E * ((gsum / n_tok)
                                              * share[li]).sum()
            if grads:
                part.backward()
            loss += float(part.detach())
            del logits, routing, part
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if own is not None and mine:
        own.extend(torch.cat(layer) for layer in zip(*mine))
    if not grads:
        return loss, None
    return loss, {path: (t.grad if t.grad is not None
                         else torch.zeros_like(t))
                  for path, t in flat.items()}


def powersync(grads: Dict, residual: Dict, lambda_rows: float,
              lambda_cols: float, min_dense_size: int = 4096):
    """Plain PowerSync on one shard (the paper's power rows x power
    columns, error feedback): per leaf, the synced gradient (in the
    gradient's dtype) and the new residual, from ``torch.topk`` and
    indexing.  Leaves are dicts path -> tensor."""
    synced, new_res = {}, {}
    for path, g in grads.items():
        acc = g.float() + residual[path]
        if acc.dim() < 2 or acc.numel() <= min_dense_size:
            synced[path] = acc.to(g.dtype)
            new_res[path] = torch.zeros_like(acc)
            continue
        a2 = acc.reshape(-1, acc.shape[-1])
        rows, cols = a2.shape
        P = max(1, int(round(lambda_rows * rows)))
        Pc = max(1, int(round(lambda_cols * cols)))
        sel_r = torch.topk(a2.abs().sum(1), P).indices
        sel_c = torch.topk(a2[sel_r].abs().sum(0), Pc).indices
        r_ix, c_ix = sel_r[:, None], sel_c[None, :]
        s = torch.zeros_like(a2)
        s[r_ix, c_ix] = a2[r_ix, c_ix]
        res = a2.clone()
        res[r_ix, c_ix] = 0.0
        synced[path] = s.reshape(acc.shape).to(g.dtype)
        new_res[path] = res.reshape(acc.shape)
    return synced, new_res


def adamw(grads: Dict, master: Dict, m: Dict, v: Dict, step: int, *,
          lr: float, warmup_steps: int, b1: float, b2: float, eps: float,
          weight_decay: float, grad_clip: float):
    """Plain AdamW (decoupled weight decay) in float32, step ``step``
    (counted from 1) from the state (``master``, ``m``, ``v``): the
    gradients scaled to a global L2 norm of at most ``grad_clip``, the rate
    warmed up linearly over ``warmup_steps``, both moments bias-corrected,
    the decay on leaves of two or more dims.  Yields, leaf by leaf (dicts
    path -> tensor), (path, new master, new m, new v)."""
    norm = math.sqrt(sum(float(g.double().pow(2).sum())
                         for g in grads.values()))
    clip = min(grad_clip / max(norm, 1e-9), 1.0)
    rate = lr * min(step / max(warmup_steps, 1), 1.0)
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for path, g in grads.items():
        g = g.float() * clip
        m1 = b1 * m[path] + (1 - b1) * g
        v1 = b2 * v[path] + (1 - b2) * g * g
        d = (m1 / c1) / ((v1 / c2).sqrt() + eps)
        w = master[path]
        if w.dim() >= 2:
            d = d + weight_decay * w
        yield path, w - rate * d, m1, v1


# ------------------------------------------------------------- the tree

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _unflatten(tree, flat: Dict, path=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, flat, path + (i,)) for i, v in enumerate(tree)]
    return flat[path]


def leaves(tree) -> Dict:
    """The tree's leaves, path -> tensor, in sorted-key order."""
    return dict(_leaves(tree))
