"""Plain float32 reference of the served decoders (dense and MoE), written
from the configuration file alone. It imports nothing of the program.

One sequence at a time, teacher-forced: the prompt and the served
tokens go through every layer at once (causal attention, no cache), and
the logits at the prompt's last position and at each served token's
position are what a served token is judged by.

What the serving path fixes and the reference repeats:

* the block of the configuration's ``assumed`` list: RMSNorm with a
  float32 scale, rotary on the whole head dim (half-split, float32
  angles ``theta ** -(i / half)``), grouped-query attention where query
  head ``h`` reads kv head ``h // (heads / kv_heads)``, per-head qk-norm
  when set, squared-ReLU or SwiGLU FFN, an untied float32 unembedding;
* an MoE layer routes each *call* of the serving path on its own:
  GShard capacity ``ceil(S * k * cf / E)`` per call of ``S`` tokens,
  float32 router, a stable descending sort (ties to the lower expert),
  the top-k gates renormalised, slots placed choice-major then in
  sequence order, an overflowing choice dropped with its gate. A prompt
  is served in chunks of ``chunk`` lanes from position 0 (adopted
  prefixes are whole chunks), so each chunk is one call; the last chunk
  also carries its pad lanes (token 0 at the positions past the
  prompt), which take capacity. A pad lane's attention reads the
  prompt's positions only (what the serving path reads past the prompt
  is whatever its cache pages hold). Each generated token is a call of
  one token, which never drops.

``precision="fp8"`` is the control: every matmul against a weight takes
its weight (per output channel) and its input (per token) rounded to
float8 e4m3 first, then multiplies in float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]

E4M3_MAX = 448.0


def strict_float32() -> None:
    """Float32 matmuls in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the amax over ``dim`` maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = (x * scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return q.float() / scale


class Reference:
    def __init__(self, weights: Tree, dm: Dict[str, Any], device,
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        strict_float32()
        self.w, self.dm, self.precision = weights, dm, precision
        self.device = torch.device(device)

    # ------------------------------------------------------------- pieces
    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [..., K] @ w [K, N]`` in float32 (fp8 control: both
        rounded to e4m3 first)."""
        if self.precision == "fp8":
            return fake_fp8(x, -1) @ fake_fp8(w, 0)
        return x @ w

    def _rmsnorm(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.dm["eps"]) * scale

    def _rope(self, x, pos):
        """x [T, H, hd], pos [T]."""
        half = x.shape[-1] // 2
        freq = torch.arange(half, dtype=torch.float32,
                            device=x.device) / half
        inv = torch.pow(torch.tensor(self.dm["rope_theta"],
                                     dtype=torch.float32, device=x.device),
                        -freq)
        ang = pos.float()[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights in float32, by path. (No recursive
        closure: a closure cycle would hold the float32 copies until the
        garbage collector ran.)"""
        out = {}
        stack = [("", self.w["periods"]["layer_0"])]
        while stack:
            prefix, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((f"{prefix}{k}/", v))
                else:
                    out[prefix + k] = v[i].to(self.device, torch.float32)
        return out

    def _attention(self, q, k, v, causal_len: Optional[int]):
        """q [Tq, H, hd] at positions ``0..Tq-1`` (causal) or, with
        ``causal_len``, all reading keys ``[0, causal_len)``."""
        dm = self.dm
        g = dm["heads"] // dm["kv_heads"]
        kx = k.repeat_interleave(g, dim=1)
        vx = v.repeat_interleave(g, dim=1)
        tq, tk = q.shape[0], kx.shape[0]
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(dm["hd"])
        # a few heads at a time bounds the [h, Tq, Tk] scores
        step = max(1, int(2 ** 28 // max(tq * tk, 1)))
        for h0 in range(0, dm["heads"], step):
            qs = q[:, h0:h0 + step].transpose(0, 1) * scale
            sc = qs @ kx[:, h0:h0 + step].permute(1, 2, 0)   # [h, Tq, Tk]
            if causal_len is None:
                mask = torch.ones(tq, tk, dtype=torch.bool,
                                  device=q.device).tril()
            else:
                mask = (torch.arange(tk, device=q.device)
                        < causal_len)[None, :].expand(tq, tk)
            sc = sc.masked_fill(~mask, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            out[:, h0:h0 + step] = (p @ vx[:, h0:h0 + step]
                                    .transpose(0, 1)).transpose(0, 1)
        return out

    def _qkv(self, w, h, pos):
        dm = self.dm
        d, H, KV, hd = dm["d"], dm["heads"], dm["kv_heads"], dm["hd"]
        q = self._mm(h, w["mixer/wq"].reshape(d, H * hd)).view(-1, H, hd)
        k = self._mm(h, w["mixer/wk"].reshape(d, KV * hd)).view(-1, KV, hd)
        v = self._mm(h, w["mixer/wv"].reshape(d, KV * hd)).view(-1, KV, hd)
        if dm["qk_norm"]:
            q = self._rmsnorm(q, w["mixer/q_norm/scale"])
            k = self._rmsnorm(k, w["mixer/k_norm/scale"])
        return self._rope(q, pos), self._rope(k, pos), v

    def _dense_ffn(self, w, h):
        if self.dm["activation"] == "relu2":
            return self._mm(torch.square(F.relu(self._mm(h, w["ffn/in"]))),
                            w["ffn/out"])
        g = F.silu(self._mm(h, w["ffn/gate"])) * self._mm(h, w["ffn/up"])
        return self._mm(g, w["ffn/down"])

    def route(self, h: torch.Tensor, router: torch.Tensor, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One call's routing. h [S, d]. Returns (expert ids [S, k],
        gates [S, k], kept [S, k] bool)."""
        dm = self.dm
        probs = torch.softmax(self._mm(h, router), dim=-1)
        srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = dm["top_k"]
        gates, idx = srt[:, :k], order[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        onehot = F.one_hot(idx, dm["experts"]).float()          # [S, k, E]
        counts = torch.zeros(dm["experts"], device=h.device)
        pos = torch.empty(idx.shape, device=h.device)
        for j in range(k):
            oh = onehot[:, j]                                    # [S, E]
            before = torch.cumsum(oh, 0) - oh + counts
            pos[:, j] = (before * oh).sum(-1)
            counts = counts + oh.sum(0)
        return idx, gates, pos < cap

    def _moe_ffn(self, w, h, groups, singles):
        """h [T, d]. ``groups``: row-index tensors, one per call of
        several tokens; ``singles``: rows each routed in a call of its
        own, which never drops (its k choices are k distinct experts,
        each with a slot)."""
        dm = self.dm
        idx_all = torch.empty(h.shape[0], dm["top_k"], dtype=torch.long,
                              device=h.device)
        gate_all = torch.empty(h.shape[0], dm["top_k"], device=h.device)
        for rows in groups:
            s = int(rows.numel())
            cap = max(1, math.ceil(s * dm["top_k"] * dm["capacity_factor"]
                                   / dm["experts"]))
            idx, gates, kept = self.route(h[rows], w["ffn/router"], cap)
            idx_all[rows] = idx
            gate_all[rows] = gates * kept
        if singles.numel():
            idx, gates, _ = self.route(h[singles], w["ffn/router"],
                                       cap=dm["top_k"] * int(singles.numel()))
            idx_all[singles] = idx
            gate_all[singles] = gates
        y = torch.zeros_like(h)
        for e in range(dm["experts"]):
            tok, slot = torch.nonzero(idx_all == e, as_tuple=True)
            if not tok.numel():
                continue
            x = h[tok]
            a = (F.silu(self._mm(x, w["ffn/gate"][e]))
                 * self._mm(x, w["ffn/up"][e]))
            y.index_add_(0, tok, self._mm(a, w["ffn/down"][e])
                         * gate_all[tok, slot][:, None])
        return y

    # -------------------------------------------------------------- forward
    def hidden(self, tokens, prompt_len: int, chunk: int) -> torch.Tensor:
        """Final-norm hidden states [T, d] (float32) of ``tokens`` (the
        prompt, then the served tokens but the last), served with prefill
        chunks of ``chunk`` lanes."""
        dm = self.dm
        dev = self.device
        ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        T, lp = int(ids.numel()), int(prompt_len)
        moe = dm["experts"] > 0
        n_pad = (-lp) % chunk if moe else 0
        emb = self.w["embed"]["tokens"]
        x = emb[ids].to(dev, torch.float32)
        xp = emb[torch.zeros(n_pad, dtype=torch.long, device=emb.device)
                 ].to(dev, torch.float32)
        pos = torch.arange(T, device=dev)
        pos_p = lp + torch.arange(n_pad, device=dev)
        groups = singles = None
        if moe:
            # rows of [x; xp]: prompt chunks (the last with its pad
            # lanes at rows T..T+n_pad-1); each generated token alone
            groups = [torch.arange(c0, min(c0 + chunk, lp), device=dev)
                      for c0 in range(0, lp, chunk)]
            groups[-1] = torch.cat([groups[-1],
                                    T + torch.arange(n_pad, device=dev)])
            singles = torch.arange(lp, T, device=dev)
        for i in range(dm["layers"]):
            w = self._layer_weights(i)
            h = self._rmsnorm(x, w["ln1/scale"])
            q, k, v = self._qkv(w, h, pos)
            a = self._attention(q, k, v, None)
            wo = w["mixer/wo"].reshape(dm["heads"] * dm["hd"], dm["d"])
            x = x + self._mm(a.reshape(T, -1), wo)
            if n_pad:
                hp = self._rmsnorm(xp, w["ln1/scale"])
                qp, _, _ = self._qkv(w, hp, pos_p)
                ap = self._attention(qp, k, v, lp)
                xp = xp + self._mm(ap.reshape(n_pad, -1), wo)
            if moe:
                both = torch.cat([x, xp])
                y = self._moe_ffn(w, self._rmsnorm(both, w["ln2/scale"]),
                                  groups, singles)
                x, xp = x + y[:T], xp + y[T:]
            else:
                x = x + self._dense_ffn(w, self._rmsnorm(x, w["ln2/scale"]))
            del w
        return self._rmsnorm(x, self.w["final_norm"]["scale"].to(
            dev, torch.float32))

    def _head(self) -> torch.Tensor:
        if self.dm["tied"]:
            return self.w["embed"]["tokens"].t()
        return self.w["lm_head"]["kernel"]

    def logit_blocks(self, hidden: torch.Tensor, block: int = 256
                     ) -> Iterator[Tuple[int, torch.Tensor]]:
        """``(start, logits [n, V] float32)`` of ``hidden`` rows, a block
        of rows at a time (the head is cast a block of vocab rows at a
        time)."""
        head = self._head()
        V = head.shape[1]
        step = 32768
        for r0 in range(0, hidden.shape[0], block):
            hb = hidden[r0:r0 + block]
            out = torch.empty(hb.shape[0], V, device=hb.device)
            for v0 in range(0, V, step):
                out[:, v0:v0 + step] = self._mm(
                    hb, head[:, v0:v0 + step].to(hb.device, torch.float32))
            yield r0, out


def served_gaps(ref: Reference, prompt, served, chunk: int,
                control: Optional[Reference] = None) -> torch.Tensor:
    """Per served token, how far its logit lies below the reference's
    best (``max - logit[token]``, 0 where the token is the reference's
    argmax). With ``control``, the same for the token the control puts
    first at each position (the served tokens are the context)."""
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    served = torch.as_tensor(served, dtype=torch.long)
    seq = torch.cat([prompt, served[:-1]])
    lp = int(prompt.numel())
    hid = ref.hidden(seq, lp, chunk)[lp - 1:]
    picks = served.to(hid.device)
    if control is not None:
        chid = control.hidden(seq, lp, chunk)[lp - 1:]
        picks = torch.cat([blk.argmax(-1) for _, blk in
                           control.logit_blocks(chid)])
        del chid
    gaps = []
    for r0, blk in ref.logit_blocks(hid):
        p = picks[r0:r0 + blk.shape[0]]
        gaps.append(blk.max(-1).values
                    - blk.gather(1, p[:, None])[:, 0])
    return torch.cat(gaps)
