"""Whisper-style encoder-decoder backbone, the audio family (counterpart
of ``repro.models.encdec.EncDecLM``).

The conv/audio frontend is a stub: the encoder reads precomputed frame
embeddings ``batch["embeds"]`` [B, S_frames, D]. The decoder is a causal
LM with cross attention into the encoder output; when serving, the cross
K/V (one per decoder layer, the encoder's length long) are computed once
at prefill and cached. RoPE stands in for Whisper's learned absolute
positions on the encoder and the decoder's self attention; cross
attention has none.

Parameters keep the reference's tree: ``encoder/periods/...`` and
``decoder/periods/...`` stacked over their layers on a leading axis,
``encoder/final_norm``, ``decoder/final_norm``, ``embed`` and, with
untied embeddings, ``lm_head``. The decode cache is ``{"cross":
{"cross_k", "cross_v"}, "self": {"k", "v"}, "len"}``, every leaf
``[num_layers, B, T, KV, hd]``; the self cache is written in place at
``len`` — a scalar (the legacy engine) or a per-row ``[B]`` vector, whose
rows past the cache drop their write as ``attention.scatter_rows`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.sharding.act import constrain_batch, local_apply

from . import attention as attn
from .common import init_params, stack_specs, tree_map
from .layers import (embed, embedding_spec, label_log_probs, lm_head_spec,
                     mlp, mlp_spec, rmsnorm, rmsnorm_spec, unembed)

Tree = Dict[str, Any]


def _enc_block_spec(cfg, dtype):
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "attn": attn.attention_spec(cfg, dtype),
            "ln2": rmsnorm_spec(cfg.d_model),
            "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation, dtype)}


def _dec_block_spec(cfg, dtype):
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "self_attn": attn.attention_spec(cfg, dtype),
            "ln_x": rmsnorm_spec(cfg.d_model),
            "cross_attn": attn.attention_spec(cfg, dtype),
            "ln2": rmsnorm_spec(cfg.d_model),
            "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation, dtype)}


class EncDecLM:
    def __init__(self, cfg):
        self.cfg = cfg
        # set by the train step as on the decoder-only LM; the
        # encoder-decoder's loss never recomputes (nor does the
        # reference's)
        self.remat = False

    # ----------------------------------------------------------- param spec
    def spec_tree(self) -> Tree:
        cfg = self.cfg
        dtype = cfg.dtype
        tree = {
            "encoder": {"periods": stack_specs(_enc_block_spec(cfg, dtype),
                                               cfg.encoder_layers),
                        "final_norm": rmsnorm_spec(cfg.d_model)},
            "decoder": {"periods": stack_specs(_dec_block_spec(cfg, dtype),
                                               cfg.num_layers),
                        "final_norm": rmsnorm_spec(cfg.d_model)},
            "embed": embedding_spec(cfg.vocab_size, cfg.d_model, dtype),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = lm_head_spec(cfg.d_model, cfg.vocab_size, dtype)
        return tree

    def init(self, generator: torch.Generator, device) -> Tree:
        """Random weights drawn from ``generator`` on ``device``."""
        return init_params(self.spec_tree(), generator, device)

    def _unembed(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        return unembed(params.get("embed"), params.get("lm_head"), x,
                       tie=self.cfg.tie_embeddings)

    # -------------------------------------------------------------- encoder
    def encode(self, params: Tree, embeds: torch.Tensor) -> torch.Tensor:
        """Frame embeddings [B,S,D] -> encoder states [B,S,D]
        (non-causal attention, then the encoder's final norm)."""
        cfg = self.cfg
        x = constrain_batch(embeds.to(cfg.dtype))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for i in range(cfg.encoder_layers):
            p = tree_map(lambda a: a[i], params["encoder"]["periods"])
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = attn.qkv_project(p["attn"], cfg, h, positions)
            y = attn.full_attention(p["attn"], cfg, q, k, v, causal=False,
                                    window=None)
            x = x + attn.attention_out(p["attn"], y, cfg.num_heads)
            h = rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + mlp(p["ffn"], h, cfg.activation)
        return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)

    # -------------------------------------------------------------- decoder
    def _cross_kv(self, p_block: Tree, enc_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V [B,S,KV,hd] from the encoder states (no
        rope on cross attention)."""
        p = p_block["cross_attn"]
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
        if self.cfg.qkv_bias:
            k = k + p["bk"]
            v = v + p["bv"]
        return k, v

    def _dec_block(self, p: Tree, x: torch.Tensor,
                   enc_out: Optional[torch.Tensor], positions: torch.Tensor,
                   *, cross_kv=None, self_cache: Optional[Tree] = None,
                   cache_len=None, write_plan=None) -> torch.Tensor:
        """One decoder layer. Without ``self_cache``: causal self
        attention over the whole ``x`` [B,S,D]. With it (one token):
        the token's K/V are written into the cache in place at
        ``cache_len`` (scalar: clamped into the cache, as
        ``dynamic_update_slice`` does; ``[B]``: per row, a row past the
        cache dropping its write), then attention reads ``cache_len +
        1`` positions. Cross attention reads ``cross_kv`` (else the K/V
        of ``enc_out``): the one-query form for a single token, full
        non-causal attention otherwise."""
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv_project(p["self_attn"], cfg, h, positions)
        if self_cache is None:
            y = attn.full_attention(p["self_attn"], cfg, q, k, v,
                                    causal=True, window=None)
        else:
            cl = torch.as_tensor(cache_len, device=x.device)
            kc, vc = self_cache["k"], self_cache["v"]
            if cl.dim() == 1:
                if write_plan is None:
                    write_plan = attn.row_write_plan(cl, kc.shape[1])
                attn.scatter_rows(kc, write_plan, k)
                attn.scatter_rows(vc, write_plan, v)
            else:
                attn.update_slice(kc, cl, k)
                attn.update_slice(vc, cl, v)
            y = attn.cached_decode_attention(p["self_attn"], cfg, q, kc, vc,
                                             cl + 1, window=None)
        x = x + attn.attention_out(p["self_attn"], y, cfg.num_heads)

        h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        qx = torch.einsum("bsd,dhk->bshk", h, p["cross_attn"]["wq"])
        if cfg.qkv_bias:
            qx = qx + p["cross_attn"]["bq"]
        kx, vx = (self._cross_kv(p, enc_out) if cross_kv is None
                  else cross_kv)
        if qx.shape[1] == 1:
            y = attn.cached_decode_attention(
                p["cross_attn"], cfg, qx, kx, vx,
                torch.tensor(kx.shape[1], dtype=torch.int32,
                             device=x.device), window=None)
        else:
            y = attn.full_attention(p["cross_attn"], cfg, qx, kx, vx,
                                    causal=False, window=None)
        x = x + attn.attention_out(p["cross_attn"], y, cfg.num_heads)

        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + mlp(p["ffn"], h, cfg.activation)

    # ---------------------------------------------------------------- train
    def decoder_logits(self, params: Tree, batch: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        """Teacher-forced logits [B,Ld,V]: the decoder run causally over
        ``batch["tokens"]`` [B,Ld] with cross attention into the encoded
        ``batch["embeds"]`` (the loss's forward)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["embeds"])
        tokens = batch["tokens"]
        b, ld = tokens.shape
        x = constrain_batch(embed(params["embed"], tokens).to(cfg.dtype))
        positions = torch.arange(ld, device=x.device)[None].expand(b, ld)
        for i in range(cfg.num_layers):
            p = tree_map(lambda a: a[i], params["decoder"]["periods"])
            x = self._dec_block(p, x, enc_out, positions)
        x = rmsnorm(params["decoder"]["final_norm"], x, cfg.norm_eps)
        return self._unembed(params, x)

    def loss_fn(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean NLL of ``batch["labels"]`` [B,Ld] under
        :meth:`decoder_logits`. Returns (loss, ``{"loss", "tokens"}``)."""
        ll = label_log_probs(self.decoder_logits(params, batch),
                             batch["labels"])
        loss = -torch.mean(ll)
        return loss, {"loss": loss,
                      "tokens": torch.tensor(ll.numel(), device=ll.device)}

    # -------------------------------------------------------------- serving
    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor], *,
                max_dec_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Tree]:
        """Encode ``batch["embeds"]``, cache every decoder layer's cross
        K/V and an empty self cache of ``max_dec_len`` (default the
        config's ``decoder_len``) positions, then decode BOS (token 0).
        Returns (logits [B,V], cache at ``len`` 1)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["embeds"])
        b = enc_out.shape[0]
        ml = max_dec_len or cfg.decoder_len
        ks, vs = [], []
        for i in range(cfg.num_layers):
            k, v = self._cross_kv(
                tree_map(lambda a: a[i], params["decoder"]["periods"]),
                enc_out)
            ks.append(k)
            vs.append(v)
        cross = {"cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}
        # the self cache lies as the cross cache does (its time dim aside)
        cache = {
            "cross": cross,
            "self": {n: local_apply(
                lambda x: torch.zeros(x.shape[:2] + (ml,) + x.shape[3:],
                                      dtype=cfg.dtype, device=x.device),
                cross["cross_k"], 2, ml) for n in ("k", "v")},
            "len": torch.zeros((), dtype=torch.int32, device=enc_out.device),
        }
        bos = torch.zeros((b,), dtype=torch.int32, device=enc_out.device)
        return self.decode_step(params, cache, bos)

    def init_cache(self, batch_size: int, enc_len: int, device) -> Tree:
        """Zero decode cache: cross K/V of ``enc_len`` encoder positions,
        a self cache of the config's ``decoder_len``, ``len`` 0."""
        cfg = self.cfg
        kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim

        def z(t):
            return torch.zeros((cfg.num_layers, batch_size, t, kvh, hd),
                               dtype=cfg.dtype, device=device)

        return {"cross": {"cross_k": z(enc_len), "cross_v": z(enc_len)},
                "self": {"k": z(cfg.decoder_len), "v": z(cfg.decoder_len)},
                "len": torch.zeros((), dtype=torch.int32, device=device)}

    def decode_step(self, params: Tree, cache: Tree, token: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tree]:
        """One decoder token per row (``token`` [B]) against the cache:
        its self K/V are written in place at ``len`` (a scalar or a
        ``[B]`` vector). Returns (logits [B,V], cache with ``len +
        1``)."""
        cfg = self.cfg
        cache_len = cache["len"]
        x = constrain_batch(
            embed(params["embed"], token[:, None]).to(cfg.dtype))
        cl = torch.as_tensor(cache_len, device=x.device)
        if cl.dim() == 1:
            positions = cl[:, None].to(torch.int32)
            plan = attn.row_write_plan(cl, cache["self"]["k"].shape[2])
        else:
            positions = cl.reshape(1, 1).expand(x.shape[0], 1).to(
                torch.int32)
            plan = None
        for i in range(cfg.num_layers):
            p = tree_map(lambda a: a[i], params["decoder"]["periods"])
            x = self._dec_block(
                p, x, None, positions,
                cross_kv=(cache["cross"]["cross_k"][i],
                          cache["cross"]["cross_v"][i]),
                self_cache={"k": cache["self"]["k"][i],
                            "v": cache["self"]["v"][i]},
                cache_len=cl, write_plan=plan)
        x = rmsnorm(params["decoder"]["final_norm"], x, cfg.norm_eps)
        logits = self._unembed(params, x)[:, 0]
        out = dict(cache)
        out["len"] = cache_len + 1
        return logits, out
