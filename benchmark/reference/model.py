"""The plain reference of the benchmark's decoders: GPT-J-6B and BLOOM.

Plain PyTorch in float32 with TF32 off, written from the published model
descriptions (HF `modeling_gptj.py`, `modeling_bloom.py`), with no kernel,
cache or batching of the program under test. It imports nothing of the
program and nothing of JAX.

The weights are the benchmark's own (`draw_group`): drawn from the seed on the
device in the served dtype, one generator and one draw per group (the
embeddings and final norm, then each layer), so any group can be drawn again
alone. The
program gets the same tensors at set-up; the reference draws each layer again
when it needs it and computes with it upcast to float32, so a whole model in
float32 never has to fit beside anything else.

Names follow the program's state dict (linear weights [out, in]), which is a
naming only: `layers.{i}.attn.wq` is GPT-J's `q_proj` and BLOOM's query
third of `query_key_value`.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

STD = 0.02          # weights and biases: STD · N(0, 1)
LN_SCALE_STD = 0.1  # LayerNorm scales: 1 + LN_SCALE_STD · N(0, 1)


def arch(config: dict, lm_head: bool = False) -> dict:
    """The widths the reference needs, from a configuration file's published
    `hf_config` (HF config.json keys) and its `family`. lm_head: the model
    carries its own LM head (GPT-J's causal LM, which SGPT-CE scores with);
    else the head is tied to `wte` (BLOOM) or absent (a bi-encoder)."""
    hf = config["hf_config"]
    fam = config["family"]
    if fam == "gptj":
        D = hf["n_embd"]
        a = dict(D=D, L=hf["n_layer"], H=hf["n_head"], F=hf.get("n_inner") or 4 * D,
                 rotary_dim=hf["rotary_dim"])
    elif fam == "bloom":
        D = hf.get("n_embed", hf.get("hidden_size"))
        a = dict(D=D, L=hf["n_layer"], H=hf.get("n_head", hf.get("num_attention_heads")),
                 F=4 * D, rotary_dim=None)
    else:
        raise ValueError(f"reference: no family {fam!r}")
    a.update(family=fam, V=hf["vocab_size"], Dh=a["D"] // a["H"],
             dtype=getattr(torch, config.get("serving", {}).get("dtype", "bfloat16")),
             eps=hf.get("layer_norm_epsilon", 1e-5),
             lm_head=bool(lm_head) and hf.get("tie_word_embeddings", True) is False)
    return a


def group_leaves(a: dict, g: int) -> List[tuple]:
    """(name, shape, kind) of group g: 0 the embeddings, final norm and LM
    head; g ≥ 1 layer g − 1. kind: "w" (weights and biases), "s" (norm scales)."""
    D, P, Fd, V = a["D"], a["H"] * a["Dh"], a["F"], a["V"]
    bloom = a["family"] == "bloom"
    if g == 0:
        out = [("wte", (V, D), "w")]
        if bloom:
            out += [("emb_ln.scale", (D,), "s"), ("emb_ln.bias", (D,), "w")]
        out += [("ln_f.scale", (D,), "s"), ("ln_f.bias", (D,), "w")]
        if a["lm_head"]:
            out += [("lm_head.w", (V, D), "w"), ("lm_head.b", (V,), "w")]
        return out
    p = f"layers.{g - 1}."
    out = [(p + "ln1.scale", (D,), "s"), (p + "ln1.bias", (D,), "w")]
    if bloom:
        out += [(p + "ln2.scale", (D,), "s"), (p + "ln2.bias", (D,), "w")]
    out += [(p + f"attn.{w}", (P, D), "w") for w in ("wq", "wk", "wv")]
    out += [(p + "attn.wo", (D, P), "w")]
    if bloom:
        out += [(p + f"attn.{b}", (P,), "w") for b in ("bq", "bk", "bv")]
        out += [(p + "attn.bo", (D,), "w")]
    out += [(p + "mlp.wi", (Fd, D), "w"), (p + "mlp.bi", (Fd,), "w"),
            (p + "mlp.wo", (D, Fd), "w"), (p + "mlp.bo", (D,), "w")]
    return out


def group_seed(seed: int, g: int) -> int:
    """The generator seed of group g of a run's weights (any whole seed)."""
    return (int(seed) * 0x9E3779B1 + g * 0x85EBCA77 + 0x5851F42D) % (1 << 63)


@torch.no_grad()
def draw_group(a: dict, seed: int, g: int, device) -> Dict[str, torch.Tensor]:
    """Group g's tensors: one normal draw on `device` in the served dtype, cut
    into views and scaled in place. The same (seed, g) gives the same values."""
    leaves = group_leaves(a, g)
    dtype = a["dtype"]
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, g))
    buf = torch.empty(total, dtype=dtype, device=device).normal_(generator=gen)
    out, off = {}, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        if kind == "s":
            t.mul_(LN_SCALE_STD).add_(1.0)
        else:
            t.mul_(STD)
        out[name] = t
        off += n
    return out


def draw_all(a: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every group's tensors, one state dict."""
    sd = {}
    for g in range(a["L"] + 1):
        sd.update(draw_group(a, seed, g, device))
    return sd


@contextlib.contextmanager
def strict_fp32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _f32(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in p.items()}


def alibi_slopes(H: int) -> List[float]:
    """BLOOM's per-head slopes (`build_alibi_tensor`)."""
    cp2 = 2 ** math.floor(math.log2(H))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** (i + 1) for i in range(cp2)]
    if cp2 != H:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra ** (i + 1) for i in range(0, 2 * (H - cp2), 2)]
    return slopes


def _rotary(x: torch.Tensor, rd: int) -> torch.Tensor:
    """GPT-J's rotary on the first rd features of each head, pairs (2i, 2i+1)
    interleaved; x (B, T, H, Dh) float32, positions 0..T-1."""
    T = x.shape[1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, rd, 2, dtype=torch.float32, device=x.device) / rd))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv   # (T, rd/2)
    sin = ang.sin().repeat_interleave(2, -1)[None, :, None, :]
    cos = ang.cos().repeat_interleave(2, -1)[None, :, None, :]
    r = x[..., :rd]
    rot = torch.stack([-r[..., 1::2], r[..., ::2]], -1).reshape(r.shape)
    return torch.cat([r * cos + rot * sin, x[..., rd:]], -1)


def _attention(a: dict, p: dict, h: torch.Tensor, mask: torch.Tensor, pre: str) -> torch.Tensor:
    B, T, _ = h.shape
    H, Dh = a["H"], a["Dh"]
    bloom = a["family"] == "bloom"
    q, k, v = (F.linear(h, p[pre + w], p.get(pre + b) if bloom else None).view(B, T, H, Dh)
               for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    if a["rotary_dim"]:
        q, k = _rotary(q, a["rotary_dim"]), _rotary(k, a["rotary_dim"])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    pos = torch.arange(T, device=h.device)
    if bloom:   # slope · key position (right-padded rows: the key's index)
        slopes = torch.tensor(alibi_slopes(H), dtype=torch.float32, device=h.device)
        s = s + slopes[None, :, None, None] * pos.float()[None, None, None, :]
    ok = (pos[None, :] <= pos[:, None])[None, None] & mask[:, None, None, :]
    s = s.masked_fill(~ok, torch.finfo(torch.float32).min)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).reshape(B, T, H * Dh)
    return F.linear(o, p[pre + "wo"], p.get(pre + "bo"))


def _mlp(p: dict, h: torch.Tensor, pre: str) -> torch.Tensor:
    x = F.gelu(F.linear(h, p[pre + "wi"], p[pre + "bi"]), approximate="tanh")
    return F.linear(x, p[pre + "wo"], p[pre + "bo"])


def _layer(a: dict, p: dict, i: int, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    pre = f"layers.{i}."
    ln = lambda t, n: F.layer_norm(t, (a["D"],), p[pre + n + ".scale"], p[pre + n + ".bias"],
                                   a["eps"])
    h = ln(x, "ln1")
    if a["family"] == "gptj":   # parallel residual
        return x + _attention(a, p, h, mask, pre + "attn.") + _mlp(p, h, pre + "mlp.")
    x = x + _attention(a, p, h, mask, pre + "attn.")
    return x + _mlp(p, ln(x, "ln2"), pre + "mlp.")


def hidden_states(a: dict, seed: int, rows: Sequence[Sequence[int]], device,
                  block_tokens: int = 16384) -> List[torch.Tensor]:
    """Final hidden states (after ln_f), float32, of each row of token ids:
    a list of (len(row), D) tensors. Rows run in blocks of similar length
    (at most `block_tokens` padded tokens a block), layer by layer, each
    layer's weights drawn again and upcast once for all blocks."""
    order = sorted(range(len(rows)), key=lambda i: -len(rows[i]))
    blocks, cur = [], []
    for i in order:
        if cur and (len(cur) + 1) * len(rows[cur[0]]) > block_tokens:
            blocks.append(cur)
            cur = []
        cur.append(i)
    if cur:
        blocks.append(cur)
    with strict_fp32(), torch.no_grad():
        g0 = _f32(draw_group(a, seed, 0, device))
        state = []
        for blk in blocks:
            T = len(rows[blk[0]])
            ids = torch.zeros((len(blk), T), dtype=torch.long)
            mask = torch.zeros((len(blk), T), dtype=torch.bool)
            for r, i in enumerate(blk):
                ids[r, :len(rows[i])] = torch.as_tensor(list(rows[i]))
                mask[r, :len(rows[i])] = True
            ids, mask = ids.to(device), mask.to(device)
            x = g0["wte"][ids]
            if a["family"] == "bloom":
                x = F.layer_norm(x, (a["D"],), g0["emb_ln.scale"], g0["emb_ln.bias"], a["eps"])
            state.append([x, mask])
        for i in range(a["L"]):
            p = _f32(draw_group(a, seed, i + 1, device))
            for s in state:
                s[0] = _layer(a, p, i, s[0], s[1])
            del p
        out: List[torch.Tensor] = [None] * len(rows)
        for blk, (x, _) in zip(blocks, state):
            x = F.layer_norm(x, (a["D"],), g0["ln_f.scale"], g0["ln_f.bias"], a["eps"])
            for r, i in enumerate(blk):
                out[i] = x[r, :len(rows[i])]
    return out


def weighted_mean(h: torch.Tensor) -> torch.Tensor:
    """SGPT's weighted-mean pooling of one row's states (n, D): position t
    (0-based) weighs t + 1."""
    w = torch.arange(1, h.shape[0] + 1, dtype=torch.float32, device=h.device)[:, None]
    return (h * w).sum(0) / w.sum()


def embed(a: dict, seed: int, rows, device) -> torch.Tensor:
    """(N, D) float32 weighted-mean embeddings of rows of token ids."""
    return torch.stack([weighted_mean(h) for h in hidden_states(a, seed, rows, device)])


def continuation_logprob(a: dict, seed: int, items, device) -> List[float]:
    """SGPT-CE's score of each (input row, continuation ids): the sum over
    the continuation's tokens of log softmax(LM head(state)) at the token,
    the state being the one at the position before it (the row's last
    len(continuation) positions)."""
    states = hidden_states(a, seed, [row for row, _ in items], device)
    with strict_fp32(), torch.no_grad():
        g0 = draw_group(a, seed, 0, device)
        w = g0["lm_head.w"].float() if a["lm_head"] else g0["wte"].float()
        b = g0["lm_head.b"].float() if a["lm_head"] else None
        out = []
        for h, (row, cont) in zip(states, items):
            lp = F.linear(h[len(row) - len(cont):], w, b).log_softmax(-1)
            tgt = torch.as_tensor(list(cont), device=device)
            out.append(float(lp.gather(1, tgt[:, None]).sum()))
    return out
