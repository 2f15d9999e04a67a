"""Dense GQA decoder on a contiguous ring KV cache: the dense branch of
``repro.models.transformer.DecoderLM`` (the OPT pair and the yi family).

Two entry points:
  ``prefill``      full-prompt forward that also populates the KV cache
  ``decode_step``  incremental forward of T new tokens against the cache
                   (T = 1 for plain decode, T = s+1 for speculative verify)

The KV cache is a ring buffer indexed by absolute position modulo cache
length, with a per-row absolute-position array ``pos`` driving the
attention mask, so rollback after a rejected speculation is a pure length
update.  Unlike the JAX package's pure functions, both entry points write
the cache in place (one K/V write per layer, no copy of the cache) and
return it.  Attention goes through ``kernels.ops.spec_verify_attn``: the
CUDA kernel for CUDA tensors, its plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, pad_vocab
from repro_torch.kernels.ops import spec_verify_attn
from repro_torch.models import common as cm
from repro_torch.models.common import ParamDef


class DecoderLM:
    """Decoder-only LM for one config; parameters and caches are passed in."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense" or cfg.attn is None:
            raise NotImplementedError(
                f"{cfg.name}: the port covers dense GQA decoders only")
        self.cfg = cfg
        self.padded_vocab = pad_vocab(cfg.vocab_size)

    # ------------------------------------------------------------------
    # parameters

    def param_defs(self) -> Dict:
        c, a = self.cfg, self.cfg.attn
        d, hd = c.d_model, a.head_dim
        H, KVH = a.n_heads, a.n_kv_heads
        return {
            "embed": ParamDef((self.padded_vocab, d), scale=0.02),
            "final_norm": ParamDef((d,), init="ones"),
            "unembed": ParamDef((self.padded_vocab, d), scale=0.02),
            "layers": {
                "attn_norm": ParamDef((d,), init="ones", stacked=True),
                "mlp_norm": ParamDef((d,), init="ones", stacked=True),
                "wq": ParamDef((d, H, hd), stacked=True),
                "wk": ParamDef((d, KVH, hd), stacked=True),
                "wv": ParamDef((d, KVH, hd), stacked=True),
                "wo": ParamDef((H, hd, d), stacked=True),
                "w_gate": ParamDef((d, c.d_ff), stacked=True),
                "w_up": ParamDef((d, c.d_ff), stacked=True),
                "w_down": ParamDef((c.d_ff, d), stacked=True),
            },
        }

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cpu") -> Dict:
        return cm.init_params(self.param_defs(), generator, self.cfg.n_layers,
                              dtype, device)

    # ------------------------------------------------------------------
    # KV cache

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> Dict:
        c, a = self.cfg, self.cfg.attn
        shape = (c.n_layers, batch, cache_len, a.n_kv_heads, a.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device),
        }

    # ------------------------------------------------------------------
    # layers

    @staticmethod
    def _layer(params: Dict, i: int) -> Dict:
        return {k: v[i] for k, v in params["layers"].items()}

    def _qkv(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor, rope):
        """x: [B,T,d] -> q [B,T,H,hd], k/v [B,T,KVH,hd] with RoPE applied
        (``rope`` is the forward's ``cm.rope_table``)."""
        a = self.cfg.attn
        B, T, d = x.shape
        q = (x @ lp["wq"].reshape(d, -1)).view(B, T, a.n_heads, a.head_dim)
        k = (x @ lp["wk"].reshape(d, -1)).view(B, T, a.n_kv_heads, a.head_dim)
        v = (x @ lp["wv"].reshape(d, -1)).view(B, T, a.n_kv_heads, a.head_dim)
        q = cm.apply_rope(q, positions, a.rope_theta, rope)
        k = cm.apply_rope(k, positions, a.rope_theta, rope)
        return q, k, v

    def _attn_decode(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos_arr: torch.Tensor, rows: torch.Tensor,
                     rope) -> torch.Tensor:
        """Write the new K/V rows at ``rows`` [B,T] (in place), then attend.
        ``pos_arr`` [B,L] already holds the new rows' positions."""
        a = self.cfg.attn
        B, T, _ = x.shape
        q, k_new, v_new = self._qkv(lp, x, positions, rope)
        bidx = torch.arange(B, device=x.device)[:, None]
        k_cache[bidx, rows] = k_new.to(k_cache.dtype)
        v_cache[bidx, rows] = v_new.to(v_cache.dtype)
        out = spec_verify_attn(q, k_cache, v_cache, positions, pos_arr,
                               window=a.window)
        return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)

    def _mlp(self, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        return cm.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])

    def _layers(self, params: Dict, x: torch.Tensor, positions: torch.Tensor,
                cache: Dict, rows: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        rope = cm.rope_table(positions, c.attn.head_dim, c.attn.rope_theta)
        for i in range(c.n_layers):
            lp = self._layer(params, i)
            hn = cm.rms_norm(x, lp["attn_norm"], c.norm_eps)
            x = x + self._attn_decode(lp, hn, positions, cache["k"][i],
                                      cache["v"][i], cache["pos"], rows, rope)
            x = x + self._mlp(lp, cm.rms_norm(x, lp["mlp_norm"], c.norm_eps))
        return cm.rms_norm(x, params["final_norm"], c.norm_eps)

    def _unembed(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return cm.unembed(x, params["unembed"], self.cfg.vocab_size)

    # ------------------------------------------------------------------
    # prefill: forward + cache population

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                prompt_lens: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Right-padded prompts [B, Tp] -> (last-token logits [B, V], the
        cache written in place, seq_lens [B]).  Padded columns are written
        with position -1 and so are never attended."""
        B, T = tokens.shape
        dev = tokens.device
        L = cache["pos"].shape[1]
        if prompt_lens is None:
            prompt_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        total_lens = prompt_lens.to(torch.int32)
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        rows = (positions % L).long()
        bidx = torch.arange(B, device=dev)[:, None]
        cache["pos"][bidx, rows] = torch.where(positions < total_lens[:, None],
                                               positions, -1)
        x = self._layers(params, cm.embed(tokens, params["embed"]), positions,
                         cache, rows)
        last = x[torch.arange(B, device=dev), (total_lens - 1).long()]
        return self._unembed(params, last), cache, total_lens

    # ------------------------------------------------------------------
    # incremental decode

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    seq_lens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """tokens: [B, T], the last committed token followed by T-1 drafts, at
        absolute positions (seq_lens-1) ... (seq_lens+T-2).  Returns (logits
        [B, T, V], the cache written in place)."""
        B, T = tokens.shape
        dev = tokens.device
        L = cache["pos"].shape[1]
        positions = ((seq_lens - 1)[:, None]
                     + torch.arange(T, dtype=torch.int32, device=dev)[None]).to(torch.int32)
        rows = (positions % L).long()
        cache["pos"][torch.arange(B, device=dev)[:, None], rows] = positions
        x = self._layers(params, cm.embed(tokens, params["embed"]), positions,
                         cache, rows)
        return self._unembed(params, x), cache

    @staticmethod
    def commit(cache_out: Dict, accept_idx: torch.Tensor) -> Dict:
        """Attention-cache rollback is a pure length update done by the
        engine (stale ring rows are overwritten before they can be
        attended)."""
        return cache_out
