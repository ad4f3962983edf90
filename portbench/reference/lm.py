"""Plain PyTorch reference of the configurations' LM stack, in float32 with
TF32 off, written from the configuration file alone: no kernel, no cache,
no batching tricks, nothing of the program.

The model, a pre-norm transformer, one attention block and one MLP or MoE
block a layer:

* RMSNorm: ``x / sqrt(mean(x^2) + eps) * scale``;
* attention: q, k, v projections, RoPE on q and k (half-split rotation,
  ``theta ** (-i / (hd / 2))``), grouped-query heads (head h reads kv head
  ``h // (H / KV)``), softmax of ``q k^T / sqrt(hd)`` (causal or not), the
  output projection, the residual;
* MLP: ``(silu(h W1) * (h W3)) W2``, the residual;
* MoE: the router's softmax over the experts in float32, the top-k picks'
  weights renormalized to sum to one, each expert taking at most ``C =
  max(8, ceil8(int(T k cf / E)))`` picks, the picks ranked in row-major
  (token, k) order and the ones past capacity dropped; each token sums its
  kept picks' gated-SiLU expert outputs times their weights;
* the final RMSNorm and the head; a text model embeds tokens, the audio
  model projects its frames;
* the loss: the mean cross-entropy of ``labels`` in float32; a decoder
  scores position t against label t + 1 (its batches already hold the
  shifted labels, as the configurations are run), the audio encoder each
  frame against its own label.

Training keeps the configuration's state: parameters stored in
``params_dtype`` (each update rounded to it), float32 moments, AdamW with
the global-norm clip, bias corrections and decoupled weight decay.  Each
layer runs under a checkpoint so that a step fits on the card.

``quant="fp8"`` is the control: every product's operands, forward and
backward, rounded to float8 e4m3 with a scale a tensor, the step below the
bfloat16 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.spec import check_run_as


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, and back to float32."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _Q8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = q8(a), q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = q8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Model:
    """The reference over one configuration file (``cfg``)."""

    def __init__(self, cfg: dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        run = check_run_as(cfg)
        self.cfg, self.quant = cfg, quant
        self.D, self.L = cfg["hidden_size"], cfg["num_hidden_layers"]
        self.H, self.KV, self.hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                                    cfg["head_dim"])
        self.eps, self.theta = run["norm_eps"], run["rope_theta"]
        self.rope_fraction = run["rope_fraction"]
        self.causal, self.decoder = run["causal"], run["decoder"]
        self.audio = run["frontend"] == "audio"
        self.moe = run["ffn"] == "moe"
        if self.moe:
            self.E, self.K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
            self.cf = run["capacity_factor"]

    # -- pieces ---------------------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            return _Q8MatMul.apply(a, b)
        return a @ b

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.mm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * scale

    def rope(self, x: torch.Tensor) -> torch.Tensor:  # [b, s, h, hd]
        b, s, h, hd = x.shape
        rot = int(hd * self.rope_fraction)
        rot -= rot % 2
        if rot == 0:
            return x
        half = rot // 2
        freqs = self.theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)

    def attention(self, p: Dict, x: torch.Tensor, kv_out: Optional[list] = None):
        b, s, D = x.shape
        H, KV, hd = self.H, self.KV, self.hd
        h = self.rms(x, p["attn.norm"])
        q = self.rope(self.linear(h, p["attn.wq"]).reshape(b, s, H, hd))
        k = self.rope(self.linear(h, p["attn.wk"]).reshape(b, s, KV, hd))
        v = self.linear(h, p["attn.wv"]).reshape(b, s, KV, hd)
        if kv_out is not None:
            kv_out.append((k.detach(), v.detach()))
        g = H // KV
        qh = q.permute(0, 2, 1, 3).reshape(b * H, s, hd)
        kh = k.repeat_interleave(g, dim=2).permute(0, 2, 3, 1).reshape(b * H, hd, s)
        vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).reshape(b * H, s, hd)
        logits = self.mm(qh, kh) / math.sqrt(hd)
        if self.causal:
            mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        out = self.mm(torch.softmax(logits, dim=-1), vh)
        out = out.reshape(b, H, s, hd).permute(0, 2, 1, 3).reshape(b, s, H * hd)
        return x + self.linear(out, p["attn.wo"])

    def mlp(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        h = self.rms(x, p["mlp.norm"])
        return x + self.linear(F.silu(self.linear(h, p["mlp.w1"])) * self.linear(h, p["mlp.w3"]),
                               p["mlp.w2"])

    def capacity(self, T: int) -> int:
        c = int(T * self.K * self.cf / self.E)
        return max(8, -(-c // 8) * 8)

    def moe_block(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        b, s, D = x.shape
        T, E, K = b * s, self.E, self.K
        h = self.rms(x, p["moe.norm"]).reshape(T, D)
        probs = torch.softmax(self.mm(h, p["moe.router"]), dim=-1)
        idx = torch.topk(probs.detach(), K, dim=-1).indices  # [T, K]
        w = probs.gather(-1, idx)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        onehot = F.one_hot(idx.reshape(-1), E)  # [T*K, E], row-major (token, k)
        rank = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1).reshape(T, K)
        keep = rank < self.capacity(T)
        out = torch.zeros_like(h)
        w1, w3, w2 = (p[f"moe.{n}"].unbind(0) for n in ("w1", "w3", "w2"))
        for e in range(E):
            tok, kk = torch.nonzero((idx == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            he = h[tok]
            ye = self.mm(F.silu(self.mm(he, w1[e])) * self.mm(he, w3[e]), w2[e])
            out = out.index_add(0, tok, ye * w[tok, kk][:, None])
        return x + out.reshape(b, s, D)

    def layer(self, p: Dict, x: torch.Tensor, kv_out: Optional[list] = None) -> torch.Tensor:
        x = self.attention(p, x, kv_out)
        return self.moe_block(p, x) if self.moe else self.mlp(p, x)

    def embed(self, params: Dict, batch: Dict) -> torch.Tensor:
        if self.audio:
            return self.linear(batch["frames"].float(), params["frontend_proj"])
        return params["embed"][batch["tokens"].long()]

    @staticmethod
    def layer_params(params: Dict, views: Dict, l: int) -> Dict:
        return {k: views[k][l] for k in views}

    # -- entries --------------------------------------------------------------

    def logits(self, params: Dict, batch: Dict, remat: bool = False,
               last_only: bool = False, kv_out: Optional[list] = None) -> torch.Tensor:
        """Logits ``[b, s or 1, vocab]`` of float32 ``params`` (the
        benchmark's leaves); with ``kv_out``, each layer's (k, v) after
        RoPE is appended to it."""
        views = {k: v.unbind(0) for k, v in params.items() if "." in k}
        x = self.embed(params, batch)
        for l in range(self.L):
            p = self.layer_params(params, views, l)
            if remat:
                x = checkpoint(self.layer, p, x, use_reentrant=False)
            else:
                x = self.layer(p, x, kv_out)
        if last_only:
            x = x[:, -1:]
        return self.linear(self.rms(x, params["final_norm"]), params["head"])

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        logits = self.logits(params, batch, remat=True)
        labels = batch["labels"].long()
        if self.decoder:
            logits, labels = logits[:, :-1], labels[:, 1:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels[..., None]).mean()


def train(cfg: dict, params: Dict[str, torch.Tensor], batches: List[Dict], adam: dict,
          quant: Optional[str] = None, against: Sequence[Dict[str, torch.Tensor]] = (),
          keep_first_grad: bool = False) -> dict:
    """``len(batches)`` AdamW steps of the reference from ``params`` (the
    benchmark's leaves in the configuration's type; updated in place).
    Returns each step's loss, the first step's clipped gradient's norm a
    leaf and each leaf's change after the last step.  For each tree of
    ``against`` (another side's first gradient, leaves on the host) it also
    returns ``first_grad_dist``: each leaf's norm of that gradient's
    difference from this one; with ``keep_first_grad`` the first gradient
    itself, on the host (``first_grad_host``)."""
    model = Model(cfg, quant)
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()}
    v2 = {k: torch.zeros_like(t) for k, t in m.items()}
    b1, b2, eps, lr = adam["b1"], adam["b2"], adam["eps"], adam["lr"]
    wd, clip = adam["weight_decay"], adam["grad_clip"]
    losses, first_grad = [], {}
    dist: List[Dict[str, float]] = [{} for _ in against]
    kept: Dict[str, torch.Tensor] = {}
    for t, batch in enumerate(batches, start=1):
        p32 = {k: v.detach().float().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = model.loss(p32, batch)
            names = list(p32)
            grads = dict(zip(names, torch.autograd.grad(loss, [p32[k] for k in names])))
        losses.append(float(loss.detach()))
        gn = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        scale = min(clip / max(gn, 1e-9), 1.0) if clip > 0 else 1.0
        b1t, b2t = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for k, g in grads.items():
                g = g * scale
                if t == 1:
                    first_grad[k] = float(g.norm())
                    for d, other in zip(dist, against):
                        d[k] = float((g - other[k].to(g.device)).norm())
                    if keep_first_grad:
                        kept[k] = g.cpu()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (m[k] / b1t) / (torch.sqrt(v2[k] / b2t) + eps)
                if wd:
                    upd = upd + wd * p32[k].detach()
                params[k].copy_((p32[k].detach() - lr * upd).to(params[k].dtype))
        del p32, grads
    change = {k: float((params[k].float() - start[k].float()).norm()) for k in params}
    out = {"losses": losses, "first_grad": first_grad, "change": change}
    if against:
        out["first_grad_dist"] = dist
    if keep_first_grad:
        out["first_grad_host"] = kept
    return out


def prefill(cfg: dict, params: Dict[str, torch.Tensor], batch: Dict,
            quant: Optional[str] = None) -> dict:
    """What a prefill call answers, from float32 ``params``: a decoder's
    last-position logits and every layer's (k, v); an encoder's logits at
    every position."""
    model = Model(cfg, quant)
    kv: list = []
    with torch.no_grad():
        logits = model.logits(params, batch, last_only=model.decoder,
                              kv_out=kv if model.decoder else None)
    return {"logits": logits, "kv": kv}
