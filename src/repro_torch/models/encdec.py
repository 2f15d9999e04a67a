"""Encoder-decoder transformer (SeamlessM4T-large-v2, arXiv:2308.11596): the
port of ``repro.models.encdec.EncDecLM``.  The modality frontend is a stub,
as in the JAX package: the encoder takes precomputed frame embeddings
``src_embeds`` [B, S, d].

Decoder = causal self-attention (ring-buffer KV cache, rolled back by a
length update) + cross-attention to the encoder's output (the cross K/V
computed once at prefill, never rolled back) + SwiGLU MLP.

Bidirectional and cross visibility reuse the position masks: the encoder's
self-attention and the cross-attention pass ``q_pos = S`` (at least every
key position) for every query row, so ``k_pos <= q_pos`` admits every
valid key, while padded source rows carry ``k_pos = -1`` and stay masked.

Attention runs where JAX runs it:

* the encoder's self-attention (``flash_attention_train`` in JAX), the
  training ``forward``'s causal self-attention (the same) and ``prefill``'s
  over the prompt's own K/V (``flash_attention_tri``) go through
  ``kernels.ops.flash_attn``: K4 on the card, differentiable, its plain
  version on the CPU.  A padded prompt row (position -1) gets K4's zeros,
  as ``flash_attention_tri`` gives; a padded source row in the encoder
  still attends, at ``q_pos = S``, as in JAX.
* the cross-attention and ``decode_step``'s self-attention over the ring
  are JAX's plain ``gqa_attention`` (:func:`~repro_torch.models.common.
  gqa_attention`): its ``-1e30`` softmax gives a row that sees no key (a
  request whose ``src_lens`` is 0) the mean of the value rows.

Every norm is K5 (``kernels.ops.rmsnorm``).  As ``DecoderLM``, ``prefill``
and ``decode_step`` write the cache in place and return it; a cache whose
cross leaves (``xk``, ``xv``, ``xpos``) were made for another source length
gets new ones at prefill, as JAX's prefill replaces them.  There is no
paged pool, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, pad_vocab
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attn
from repro_torch.models import common as cm
from repro_torch.models.common import ParamDef
from repro_torch.models.transformer import _pick, _unbind


class EncDecLM:
    """Encoder-decoder LM for one config; parameters and caches are passed in."""

    def __init__(self, cfg: ModelConfig):
        if not cfg.is_encdec or cfg.attn is None or cfg.enc_layers < 1:
            raise ValueError(f"{cfg.name}: EncDecLM takes an encoder-decoder config "
                             "with attention and at least one encoder layer")
        self.cfg = cfg
        self.padded_vocab = pad_vocab(cfg.vocab_size)

    # ------------------------------------------------------------------
    # parameters

    def _attn_defs(self) -> Dict[str, ParamDef]:
        a, d = self.cfg.attn, self.cfg.d_model
        return {
            "wq": ParamDef((d, a.n_heads, a.head_dim), stacked=True),
            "wk": ParamDef((d, a.n_kv_heads, a.head_dim), stacked=True),
            "wv": ParamDef((d, a.n_kv_heads, a.head_dim), stacked=True),
            "wo": ParamDef((a.n_heads, a.head_dim, d), stacked=True),
        }

    def _mlp_defs(self) -> Dict[str, ParamDef]:
        c = self.cfg
        return {
            "w_gate": ParamDef((c.d_model, c.d_ff), stacked=True),
            "w_up": ParamDef((c.d_model, c.d_ff), stacked=True),
            "w_down": ParamDef((c.d_ff, c.d_model), stacked=True),
        }

    def param_defs(self) -> Dict:
        d = self.cfg.d_model

        def norm():
            return ParamDef((d,), init="ones", stacked=True)
        enc = {"attn_norm": norm(), "mlp_norm": norm(), **self._attn_defs(), **self._mlp_defs()}
        dec = {
            "self_norm": norm(), "cross_norm": norm(), "mlp_norm": norm(),
            **{f"self_{k}": v for k, v in self._attn_defs().items()},
            **{f"cross_{k}": v for k, v in self._attn_defs().items()},
            **self._mlp_defs(),
        }
        return {
            "embed": ParamDef((self.padded_vocab, d), scale=0.02),
            "enc_final_norm": ParamDef((d,), init="ones"),
            "final_norm": ParamDef((d,), init="ones"),
            "unembed": ParamDef((self.padded_vocab, d), scale=0.02),
            "enc": enc,   # stacked enc_layers
            "dec": dec,   # stacked n_layers
        }

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cuda") -> Dict:
        """Seeded parameters on ``device`` (the top-level leaves, then the
        encoder's, then the decoder's, from one generator that lives
        there)."""
        device = resolve_device(device)
        defs = self.param_defs()
        top = {k: v for k, v in defs.items() if isinstance(v, ParamDef)}
        out = cm.init_params(top, generator, 0, dtype, device)
        out["enc"] = cm.init_params(defs["enc"], generator, self.cfg.enc_layers, dtype, device)
        out["dec"] = cm.init_params(defs["dec"], generator, self.cfg.n_layers, dtype, device)
        return out

    # ------------------------------------------------------------------
    # cache

    def init_cache(self, batch: int, cache_len: int, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda", src_len: int = 0) -> Dict:
        """Self-attention ring ``k``/``v [nL, B, L, KVH, hd]`` with ``pos
        [B, L]`` (L = ``cache_len``, or the window when smaller), and the
        cross K/V ``xk``/``xv [nL, B, src_len, KVH, hd]`` with ``xpos [B,
        src_len]``; positions -1 where unwritten."""
        c, a = self.cfg, self.cfg.attn
        device = resolve_device(device)
        L = min(cache_len, a.window) if a.window else cache_len
        rows = (c.n_layers, batch)
        kv = (a.n_kv_heads, a.head_dim)
        return {
            "k": torch.zeros((*rows, L, *kv), dtype=dtype, device=device),
            "v": torch.zeros((*rows, L, *kv), dtype=dtype, device=device),
            "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
            "xk": torch.zeros((*rows, src_len, *kv), dtype=dtype, device=device),
            "xv": torch.zeros((*rows, src_len, *kv), dtype=dtype, device=device),
            "xpos": torch.full((batch, src_len), -1, dtype=torch.int32, device=device),
        }

    # ------------------------------------------------------------------
    # layers

    def _qkv(self, lp: Dict, x: torch.Tensor, prefix: str, rope) -> Tuple[torch.Tensor, ...]:
        """x [B,T,d] -> q [B,T,H,hd], k/v [B,T,KVH,hd] through the
        ``{prefix}wq``/``wk``/``wv`` weights, RoPE on q and k."""
        a = self.cfg.attn
        B, T, d = x.shape
        q = (x @ lp[prefix + "wq"].reshape(d, -1)).view(B, T, a.n_heads, a.head_dim)
        k = (x @ lp[prefix + "wk"].reshape(d, -1)).view(B, T, a.n_kv_heads, a.head_dim)
        v = (x @ lp[prefix + "wv"].reshape(d, -1)).view(B, T, a.n_kv_heads, a.head_dim)
        return (cm.apply_rope(q, None, a.rope_theta, rope),
                cm.apply_rope(k, None, a.rope_theta, rope), v)

    def _out(self, lp: Dict, o: torch.Tensor, name: str) -> torch.Tensor:
        B, T = o.shape[:2]
        return o.reshape(B, T, -1) @ lp[name].reshape(-1, self.cfg.d_model)

    def _mlp(self, lp: Dict, h: torch.Tensor) -> torch.Tensor:
        hn = cm.rms_norm(h, lp["mlp_norm"], self.cfg.norm_eps)
        return cm.swiglu(hn, lp["w_gate"], lp["w_up"], lp["w_down"])

    def _cross_kv(self, lp: Dict, enc_out: torch.Tensor):
        """Layer ``lp``'s cross K/V of the encoder output, [B,S,KVH,hd] each."""
        a = self.cfg.attn
        B, S, d = enc_out.shape
        xk = (enc_out @ lp["cross_wk"].reshape(d, -1)).view(B, S, a.n_kv_heads, a.head_dim)
        xv = (enc_out @ lp["cross_wv"].reshape(d, -1)).view(B, S, a.n_kv_heads, a.head_dim)
        return xk, xv

    def _cross(self, lp: Dict, hn: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
               xpos: torch.Tensor) -> torch.Tensor:
        """Cross-attention of decoder states hn [B,T,d] over the encoder's
        K/V (plain ``gqa_attention``, every query at position S), through
        ``cross_wo``."""
        a = self.cfg.attn
        B, T, d = hn.shape
        q = (hn @ lp["cross_wq"].reshape(d, -1)).view(B, T, a.n_heads, a.head_dim)
        full_q = torch.full((B, T), xk.shape[1], dtype=torch.int32, device=hn.device)
        o = cm.gqa_attention(q, xk, xv, cm.position_mask(full_q, xpos, None))
        return self._out(lp, o, "cross_wo")

    def _decoder(self, params: Dict, x: torch.Tensor, positions: torch.Tensor,
                 self_attn, cross_kv) -> torch.Tensor:
        """The decoder stack: ``self_attn(lp, hn, i, rope)`` is layer i's
        self-attention output (before ``self_wo``), ``cross_kv(lp, i)`` its
        cross K/V and their positions."""
        c = self.cfg
        rope = cm.rope_table(positions, c.attn.head_dim, c.attn.rope_theta)
        # one unbind per stacked weight (DecoderLM._layers says why)
        layers = _unbind(params["dec"])
        for i in range(c.n_layers):
            lp = _pick(layers, i)
            hn = cm.rms_norm(x, lp["self_norm"], c.norm_eps)
            x = x + self._out(lp, self_attn(lp, hn, i, rope), "self_wo")
            hn = cm.rms_norm(x, lp["cross_norm"], c.norm_eps)
            x = x + self._cross(lp, hn, *cross_kv(lp, i))
            x = x + self._mlp(lp, x)
        return cm.rms_norm(x, params["final_norm"], c.norm_eps)

    # ------------------------------------------------------------------
    # the encoder

    def encode(self, params: Dict, src_embeds: torch.Tensor,
               src_lens: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (enc_out [B,S,d], src_pos [B,S] int32 with -1 padding).

        The frames are cast to ``cfg.dtype`` (JAX's cast), then to the
        weights' dtype: JAX promotes a ``bfloat16`` input against fp32
        weights from the first products on, where torch would refuse to
        mix them.  Bidirectional self-attention through K4 with every
        query at position S; it visits every key tile."""
        c = self.cfg
        B, S, _ = src_embeds.shape
        dev = src_embeds.device
        x = src_embeds.to(getattr(torch, c.dtype)).to(params["embed"].dtype)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        if src_lens is None:
            src_pos = pos.contiguous()
        else:
            src_pos = torch.where(pos < src_lens.to(dev)[:, None], pos, -1).to(torch.int32)
        full_q = torch.full((B, S), S, dtype=torch.int32, device=dev)
        rope = cm.rope_table(pos, c.attn.head_dim, c.attn.rope_theta)
        layers = _unbind(params["enc"])
        for i in range(c.enc_layers):
            lp = _pick(layers, i)
            hn = cm.rms_norm(x, lp["attn_norm"], c.norm_eps)
            q, k, v = self._qkv(lp, hn, "", rope)
            x = x + self._out(lp, flash_attn(q, k, v, full_q, src_pos), "wo")
            x = x + self._mlp(lp, x)
        return cm.rms_norm(x, params["enc_final_norm"], c.norm_eps), src_pos

    # ------------------------------------------------------------------
    # full-sequence forward (training / scoring)

    def forward(self, params: Dict, tokens: torch.Tensor,
                src_embeds: Optional[torch.Tensor] = None,
                src_lens: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode the source, decode the target causally: (logits [B,T,V]
        fp32, a zero aux loss).  K4 carries the encoder's and the decoder's
        self-attention (differentiable); every layer's activations are kept
        for the backward."""
        if src_embeds is None:
            raise ValueError("an encoder-decoder forward needs src_embeds")
        a = self.cfg.attn
        enc_out, src_pos = self.encode(params, src_embeds, src_lens)
        B, T = tokens.shape
        dev = tokens.device
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)

        def self_attn(lp, hn, i, rope):
            q, k, v = self._qkv(lp, hn, "self_", rope)
            return flash_attn(q, k, v, positions, positions, window=a.window)

        x = self._decoder(params, cm.embed(tokens, params["embed"]), positions, self_attn,
                          lambda lp, i: (*self._cross_kv(lp, enc_out), src_pos))
        return (cm.unembed(x, params["unembed"], self.cfg.vocab_size),
                torch.zeros((), dtype=torch.float32, device=dev))

    # ------------------------------------------------------------------
    # prefill: encode, fill the cross K/V, prefill the decoder's ring

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                prompt_lens: Optional[torch.Tensor] = None,
                src_embeds: Optional[torch.Tensor] = None,
                src_lens: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Right-padded target prompts [B, Tp] and their source -> (last-token
        logits [B, V], the cache written in place, seq_lens [B]).

        Every layer's cross K/V is computed once from the encoder output and
        stored in the cache's dtype (the layer attends the uncast rows, as
        JAX's does).  The decoder's self-attention runs K4 over the prompt's
        own K/V with padded columns at position -1 (JAX's
        ``flash_attention_tri``); the ring rows ``pos % L`` are then written,
        padded columns with position -1."""
        if src_embeds is None:
            raise ValueError("an encoder-decoder prefill needs src_embeds")
        a = self.cfg.attn
        enc_out, src_pos = self.encode(params, src_embeds, src_lens)
        B, T = tokens.shape
        S = enc_out.shape[1]
        dev = tokens.device
        dt = cache["xk"].dtype
        if cache["xk"].shape[2] != S:
            shape = (self.cfg.n_layers, B, S, a.n_kv_heads, a.head_dim)
            cache["xk"] = torch.empty(shape, dtype=dt, device=dev)
            cache["xv"] = torch.empty(shape, dtype=dt, device=dev)
            cache["xpos"] = torch.empty((B, S), dtype=torch.int32, device=dev)
        cache["xpos"].copy_(src_pos)
        if prompt_lens is None:
            prompt_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        total_lens = prompt_lens.to(torch.int32)
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        qk_pos = torch.where(positions < total_lens[:, None], positions, -1)
        rows = (positions % cache["pos"].shape[1]).long()
        bidx = torch.arange(B, device=dev)[:, None]
        cache["pos"][bidx, rows] = qk_pos

        def self_attn(lp, hn, i, rope):
            q, k, v = self._qkv(lp, hn, "self_", rope)
            out = flash_attn(q, k, v, qk_pos, qk_pos, window=a.window)
            cache["k"][i][bidx, rows] = k.to(cache["k"].dtype)
            cache["v"][i][bidx, rows] = v.to(cache["v"].dtype)
            return out

        def cross_kv(lp, i):
            xk, xv = self._cross_kv(lp, enc_out)
            cache["xk"][i] = xk
            cache["xv"][i] = xv
            return xk, xv, src_pos

        x = self._decoder(params, cm.embed(tokens, params["embed"]), positions, self_attn,
                          cross_kv)
        last = x[torch.arange(B, device=dev), (total_lens - 1).long()]
        return cm.unembed(last, params["unembed"], self.cfg.vocab_size), cache, total_lens

    # ------------------------------------------------------------------
    # incremental decode

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    seq_lens: torch.Tensor, cu_blocks: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, T] at absolute positions (seq_lens-1) ... (seq_lens+T-2)
        -> (logits [B, T, V], the cache written in place).  Self-attention
        is plain ``gqa_attention`` over the ring (as JAX's), cross-attention
        over the cached cross K/V.  ``cu_blocks`` is the engine's paged-pool
        operand; there is no paged pool here, so it must be None."""
        if cu_blocks is not None:
            raise NotImplementedError(
                "the encoder-decoder model has no paged KV pool (nor has the JAX "
                "package's); it decodes on the contiguous ring")
        a = self.cfg.attn
        B, T = tokens.shape
        dev = tokens.device
        positions = ((seq_lens - 1)[:, None]
                     + torch.arange(T, dtype=torch.int32, device=dev)[None]).to(torch.int32)
        rows = (positions % cache["pos"].shape[1]).long()
        bidx = torch.arange(B, device=dev)[:, None]
        cache["pos"][bidx, rows] = positions
        mask = cm.position_mask(positions, cache["pos"], a.window)

        def self_attn(lp, hn, i, rope):
            q, k, v = self._qkv(lp, hn, "self_", rope)
            lk, lv = cache["k"][i], cache["v"][i]
            lk[bidx, rows] = k.to(lk.dtype)
            lv[bidx, rows] = v.to(lv.dtype)
            return cm.gqa_attention(q, lk, lv, mask)

        x = self._decoder(params, cm.embed(tokens, params["embed"]), positions, self_attn,
                          lambda lp, i: (cache["xk"][i], cache["xv"][i], cache["xpos"]))
        return cm.unembed(x, params["unembed"], self.cfg.vocab_size), cache

    @staticmethod
    def commit(cache_out: Dict, accept_idx: torch.Tensor) -> Dict:
        """The ring rolls back by a length update (stale rows are rewritten
        before they are attended) and the cross K/V never changes."""
        return cache_out
