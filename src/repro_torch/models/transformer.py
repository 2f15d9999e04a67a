"""Dense GQA decoder on a contiguous ring KV cache or a paged KV pool: the
dense branch of ``repro.models.transformer.DecoderLM`` (the OPT pair, the
yi family and internlm2).

Entry points:
  ``forward``        full-sequence forward for training and scoring
                     (attention through ``kernels.ops.flash_attn``, K4,
                     differentiable)
  ``prefill``        full-prompt forward that also populates a ring cache
  ``prefill_flash``  the same contract, attention through K4 over the
                     prompt's own K/V, then one cache write per layer
  ``decode_step``    incremental forward of T new tokens against the cache
                     (T = 1 for plain decode, T = s+1 for speculative verify)

The ring cache is indexed by absolute position modulo cache length, with a
per-row absolute-position array ``pos`` driving the attention mask, so
rollback after a rejected speculation is a pure length update.  A cache
with a block table ``bt`` is the paged pool of :meth:`init_paged_cache`
and takes the paged path.  Unlike the JAX package's pure functions, both
entry points write the cache in place (one K/V write per layer, no copy of
the cache) and return it.  Attention goes through
``kernels.ops.spec_verify_attn`` (ring) and
``kernels.paged.paged_verify_attn`` (pool): the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, pad_vocab
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attn, spec_verify_attn
from repro_torch.kernels.paged import paged_verify_attn
from repro_torch.models import common as cm
from repro_torch.models.common import ParamDef


class DecoderLM:
    """Decoder-only LM for one config; parameters and caches are passed in."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense" or cfg.attn is None:
            raise NotImplementedError(
                f"{cfg.name}: the port covers dense GQA decoders only; MLA, MoE "
                "and the other families are not ported yet (ROADMAP queue 1, item 12)")
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
             device: torch.device | str = "cuda") -> Dict:
        """Seeded parameters on ``device``; the generator must live there."""
        return cm.init_params(self.param_defs(), generator, self.cfg.n_layers,
                              dtype, resolve_device(device))

    # ------------------------------------------------------------------
    # KV cache

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> Dict:
        c, a = self.cfg, self.cfg.attn
        device = resolve_device(device)
        shape = (c.n_layers, batch, cache_len, a.n_kv_heads, a.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device),
        }

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> Dict:
        """Paged KV pool shared by every slot (the engine adds the block
        table ``bt [B, MAXB]``):

            k/v : [nL, num_blocks + 1, block_size, KVH, hd]
            pos : [num_blocks + 1, block_size]  absolute position, -1 unwritten

        Block ``num_blocks`` is a trash block that no table ever names: the
        writes the JAX package drops (``mode="drop"`` at an out-of-range
        block) land there instead, since an in-place index write has no drop
        mode.  Compare ``pos[:num_blocks]``."""
        c, a = self.cfg, self.cfg.attn
        device = resolve_device(device)
        shape = (c.n_layers, num_blocks + 1, block_size, a.n_kv_heads, a.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((num_blocks + 1, block_size), -1, dtype=torch.int32,
                              device=device),
        }

    # ------------------------------------------------------------------
    # layers

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

    def _attn_paged(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                    k_pool: torch.Tensor, v_pool: torch.Tensor,
                    pos: torch.Tensor, pb: torch.Tensor, off: torch.Tensor,
                    bt: torch.Tensor, rope,
                    cu_blocks: Optional[torch.Tensor]) -> torch.Tensor:
        """Write the new K/V rows at the physical addresses ``(pb, off)``
        [B,T] (in place; ``pb`` = the trash block for slots without a block
        there), then attend against the pool through the block table."""
        a = self.cfg.attn
        B, T, _ = x.shape
        q, k_new, v_new = self._qkv(lp, x, positions, rope)
        k_pool[pb, off] = k_new.to(k_pool.dtype)
        v_pool[pb, off] = v_new.to(v_pool.dtype)
        out = paged_verify_attn(q, k_pool, v_pool, positions, pos, bt,
                                window=a.window, cu_blocks=cu_blocks)
        return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)

    def _attn_full(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                   prefix_len: int, rope) -> torch.Tensor:
        """Full-sequence self attention of the training forward (the GQA
        branch of the JAX ``_attn_full(train=True)``; the port's configs
        hold no MLA).  ``positions`` [B,T] serve as query and key positions."""
        a = self.cfg.attn
        B, T, _ = x.shape
        q, k, v = self._qkv(lp, x, positions, rope)
        out = flash_attn(q, k, v, positions, positions, window=a.window,
                         prefix_len=prefix_len)
        return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)

    def _mlp(self, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        return cm.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])

    def _layers(self, params: Dict, x: torch.Tensor, positions: torch.Tensor,
                attn: Callable) -> torch.Tensor:
        """The decoder stack; ``attn(lp, hn, layer, rope)`` is the attention
        block of one layer (ring or paged)."""
        c = self.cfg
        rope = cm.rope_table(positions, c.attn.head_dim, c.attn.rope_theta)
        # one unbind per stacked weight: its backward stacks the layers'
        # gradients once, where indexing layer by layer would add a
        # full-size zero-padded gradient per layer
        layers = {k: v.unbind(0) for k, v in params["layers"].items()}
        for i in range(c.n_layers):
            lp = {k: v[i] for k, v in layers.items()}
            hn = cm.rms_norm(x, lp["attn_norm"], c.norm_eps)
            x = x + attn(lp, hn, i, rope)
            x = x + self._mlp(lp, cm.rms_norm(x, lp["mlp_norm"], c.norm_eps))
        return cm.rms_norm(x, params["final_norm"], c.norm_eps)

    def _ring_attn(self, cache: Dict, positions: torch.Tensor,
                   rows: torch.Tensor) -> Callable:
        return lambda lp, hn, i, rope: self._attn_decode(
            lp, hn, positions, cache["k"][i], cache["v"][i], cache["pos"], rows, rope)

    def _unembed(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return cm.unembed(x, params["unembed"], self.cfg.vocab_size)

    # ------------------------------------------------------------------
    # full-sequence forward (training / scoring)

    def forward(self, params: Dict, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T] -> (logits [B, T, V] fp32, aux), ``aux`` the zero
        fp32 scalar of a dense model (the JAX model's MoE aux loss).  No
        per-layer recompute: every layer's activations are kept for the
        backward."""
        if prefix_embeds is not None:
            raise NotImplementedError(
                "modality prefixes (VLM) are not ported yet (ROADMAP queue 1, item 12)")
        B, T = tokens.shape
        dev = tokens.device
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        x = self._layers(params, cm.embed(tokens, params["embed"]), positions,
                         lambda lp, hn, i, rope: self._attn_full(lp, hn, positions, 0, rope))
        return (self._unembed(params, x),
                torch.zeros((), dtype=torch.float32, device=dev))

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
                         self._ring_attn(cache, positions, rows))
        last = x[torch.arange(B, device=dev), (total_lens - 1).long()]
        return self._unembed(params, last), cache, total_lens

    def prefill_flash(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                      prompt_lens: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """:meth:`prefill` with the attention of each layer run by K4 over
        the prompt's own K/V (padded rows at position -1, never attended)
        instead of over the cache; the K/V rows are then written to the ring
        once.  Same contract and results as :meth:`prefill`."""
        if "bt" in cache or "k_scale" in cache:
            raise NotImplementedError(
                "prefill_flash covers the contiguous ring without int8 K/V; the "
                "int8 cache is not ported yet (ROADMAP queue 1, item 2)")
        c = self.cfg
        B, T = tokens.shape
        dev = tokens.device
        L = cache["pos"].shape[1]
        if prompt_lens is None:
            prompt_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        total_lens = prompt_lens.to(torch.int32)
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        qk_pos = torch.where(positions < total_lens[:, None], positions, -1)
        rows = (positions % L).long()
        bidx = torch.arange(B, device=dev)[:, None]
        cache["pos"][bidx, rows] = qk_pos

        def attn(lp, hn, i, rope):
            q, k, v = self._qkv(lp, hn, positions, rope)
            out = flash_attn(q, k, v, qk_pos, qk_pos, window=c.attn.window)
            cache["k"][i][bidx, rows] = k.to(cache["k"].dtype)
            cache["v"][i][bidx, rows] = v.to(cache["v"].dtype)
            return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, c.d_model)

        x = self._layers(params, cm.embed(tokens, params["embed"]), positions, attn)
        last = x[torch.arange(B, device=dev), (total_lens - 1).long()]
        return self._unembed(params, last), cache, total_lens

    # ------------------------------------------------------------------
    # incremental decode

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    seq_lens: torch.Tensor,
                    cu_blocks: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: [B, T], the last committed token followed by T-1 drafts, at
        absolute positions (seq_lens-1) ... (seq_lens+T-2).  Returns (logits
        [B, T, V], the cache written in place).

        A cache with a ``bt`` (block table) entry is a paged pool and takes
        the paged path; ``cu_blocks [B + 1]`` (``host_cu_blocks`` of the
        same table, on its device) selects the ragged kernel K3 there, its
        absence the dense K2."""
        if "bt" in cache:
            return self._decode_step_paged(params, tokens, cache, seq_lens,
                                           cu_blocks)
        B, T = tokens.shape
        dev = tokens.device
        L = cache["pos"].shape[1]
        positions = ((seq_lens - 1)[:, None]
                     + torch.arange(T, dtype=torch.int32, device=dev)[None]).to(torch.int32)
        rows = (positions % L).long()
        cache["pos"][torch.arange(B, device=dev)[:, None], rows] = positions
        x = self._layers(params, cm.embed(tokens, params["embed"]), positions,
                         self._ring_attn(cache, positions, rows))
        return self._unembed(params, x), cache

    def _decode_step_paged(self, params: Dict, tokens: torch.Tensor,
                           cache: Dict, seq_lens: torch.Tensor,
                           cu_blocks: Optional[torch.Tensor],
                           ) -> Tuple[torch.Tensor, Dict]:
        """Incremental decode against the paged pool.  The token at absolute
        position p of slot b lives at physical row (bt[b, p // bs], p % bs).
        A slot whose table has no block there (an empty or retired slot, bt
        = -1) writes into the trash block and reads key position -1, so the
        same step serves every occupancy level."""
        B, T = tokens.shape
        dev = tokens.device
        bt = cache["bt"]                                        # [B, MAXB]
        trash, bs = cache["pos"].shape[0] - 1, cache["pos"].shape[1]
        positions = ((seq_lens - 1)[:, None]
                     + torch.arange(T, dtype=torch.int32, device=dev)[None]).to(torch.int32)
        blk = (positions // bs).clamp(0, bt.shape[1] - 1).long()
        off = (positions % bs).long()
        pb = torch.gather(bt, 1, blk)
        pb = torch.where(pb < 0, trash, pb).long()
        cache["pos"][pb, off] = positions

        def attn(lp, hn, i, rope):
            return self._attn_paged(lp, hn, positions, cache["k"][i], cache["v"][i],
                                    cache["pos"], pb, off, bt, rope, cu_blocks)

        x = self._layers(params, cm.embed(tokens, params["embed"]), positions, attn)
        return self._unembed(params, x), cache

    @staticmethod
    def commit(cache_out: Dict, accept_idx: torch.Tensor) -> Dict:
        """Attention-cache rollback is a pure length update done by the
        engine (stale ring rows are overwritten before they can be
        attended)."""
        return cache_out
