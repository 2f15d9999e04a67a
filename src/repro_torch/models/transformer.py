"""Decoder on a contiguous ring KV cache or a paged KV pool: the port of
``repro.models.transformer.DecoderLM``, dense (the OPT pair, the yi family,
internlm2, qwen3-8b), mixture-of-experts (qwen3-moe-30b-a3b,
deepseek-v2-236b; ``models/moe.py``) or a VLM's language model
(paligemma-3b), with Qwen3's per-head q/k RMSNorm where the config asks for
it (``qk_norm``: after the projections, before RoPE).

A VLM's ``forward``, ``prefill`` and ``prefill_flash`` take
``prefix_embeds [B, P, d]`` (``P = cfg.prefix_len``, the stubbed vision
tower's patch embeddings), cast to the embedding's dtype and put before the
tokens at positions ``0 .. P-1``; the prompt follows at ``P ..``.  With
``bidirectional_prefix`` every query sees the prefix rows (PaliGemma's
prefix-LM mask): in those three entry points only when ``prefix_embeds``
is given, and in every cached step always (the config's ``prefix_len``), as
JAX passes it.

Attention is GQA, or DeepSeek-V2's MLA (``attn.kind == "mla"``): a
rank-compressed cache of ``ckv`` rows (``kv_lora_rank`` wide, RMS-normed)
and one decoupled RoPE key row ``krope`` a token, attended in JAX's
absorbed form (``q_nope @ W_uk`` scored against ``ckv``, the output
``p @ ckv`` expanded by ``W_uv``) with plain products, as JAX computes it
outside any Pallas kernel.  MLA serves on the contiguous ring
(``prefill``, ``decode_step``, ``prefill_chunk``); its full-sequence paths
(the training ``forward`` and ``prefill_flash``) expand ``ckv`` into
per-head keys and values, as JAX's do, and attend through K4 at q/k head
dim ``head_dim + rope_head_dim`` (192) and v head dim ``vdim`` (128).  Its
paged pool raises ``NotImplementedError``, as JAX has none.

Entry points:
  ``forward``        full-sequence forward for training and scoring
                     (attention through ``kernels.ops.flash_attn``, K4,
                     differentiable)
  ``prefill``        full-prompt forward that also populates a ring cache
  ``prefill_flash``  the same contract, attention through K4 over the
                     prompt's own K/V, then one cache write per layer
  ``decode_step``    incremental forward of T new tokens against the cache
                     (T = 1 for plain decode, T = s+1 for speculative verify)
  ``prefill_chunk``  one prefill chunk written at ``offset ..`` and attending
                     the prefix already in the cache (chunked prefill)
  ``decode_step_mixed``  the paged verify of every slot and one slot's
                     prefill chunk in one attention call per layer (the
                     mixed verify+chunk launch)

The ring cache is indexed by absolute position modulo cache length, with a
per-row absolute-position array ``pos`` driving the attention mask, so
rollback after a rejected speculation is a pure length update.  A cache
with a block table ``bt`` is the paged pool of :meth:`init_paged_cache`
and takes the paged path.  Unlike the JAX package's pure functions, both
entry points write the cache in place (one K/V write per layer, no copy of
the cache) and return it.  With ``cfg.kv_quant`` either cache holds int8
K/V codes with per-(row, kv-head) scales (``k_scale``/``v_scale``, in the
cache's dtype) beside them; every write site quantises the new rows
(:func:`_quant_rows`), and the attention dequantises them (the kernels tile
by tile, their plain versions through ``kernels.ref.dequant``, JAX's
``_dequant``).  Attention goes through ``kernels.ops.spec_verify_attn``
(ring) and ``kernels.paged.paged_verify_attn`` (pool): the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, pad_vocab
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attn, spec_verify_attn
from repro_torch.kernels.paged import paged_verify_attn
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models.common import ParamDef

# the per-layer leaves of a cache that hold rows (``pos`` and the block table
# ``bt`` are shared by the layers)
_SHARED = ("pos", "bt")


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(row, kv-head) quantization (``repro.models.
    transformer._quant_rows``). x: [..., hd] -> int8 codes [..., hd] and
    fp32 scales [...]: ``amax(|x|) / 127`` floored at 1e-8, codes
    ``round(x / scale)`` (half to even, as ``jnp.round``) clamped to +-127."""
    xf = x.float()
    scale = (xf.abs().amax(-1) / 127.0).clamp_min_(1e-8)
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _layer(cache: Dict, i: int) -> Dict:
    """Layer ``i``'s row leaves of a cache (``k``, ``v`` and, in an int8
    cache, ``k_scale``, ``v_scale``; ``ckv``, ``krope`` in an MLA cache):
    views, so writes land in the cache."""
    return {name: t[i] for name, t in cache.items() if name not in _SHARED}


def _stored(lc: Dict, k_new: torch.Tensor, v_new: torch.Tensor) -> Dict:
    """New K/V rows ``[B, T, KVH, hd]`` as the layer cache ``lc`` stores
    them: cast to its dtype, or int8 codes with scales in the scales'
    dtype.  k and v are quantised together, in one pass over ``[2, ...]``."""
    if "k_scale" not in lc:
        return {"k": k_new.to(lc["k"].dtype), "v": v_new.to(lc["v"].dtype)}
    codes, scales = _quant_rows(torch.stack([k_new, v_new]))
    scales = scales.to(lc["k_scale"].dtype)
    return {"k": codes[0], "v": codes[1], "k_scale": scales[0], "v_scale": scales[1]}


def _write_rows(lc: Dict, new: Dict, bidx: torch.Tensor, rows: torch.Tensor,
                valid: Optional[torch.Tensor]) -> None:
    """Write each leaf of ``new`` (rows ``[B, T, ...]`` as the layer cache
    ``lc`` stores them) at ``lc[name][bidx, rows]``, in place.  A column
    outside ``valid`` [B,T] writes its row's old value back: the ring has
    no row to drop a write into, as the JAX package's ``mode="drop"``
    does, so that row is left as it was."""
    B, T = rows.shape
    for name, t in new.items():
        if valid is not None:
            keep = valid.view(B, T, *(1,) * (t.dim() - 2))
            t = torch.where(keep, t, lc[name][bidx, rows])
        lc[name][bidx, rows] = t


def _unbind(tree: Dict) -> Dict:
    """Each stacked leaf of a (nested) layer tree split into its layers."""
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}


def _pick(tree: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters of an ``_unbind`` tree."""
    return {k: _pick(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _scales(lc: Dict, rows: slice = slice(None)) -> Dict:
    """The int8 scale arguments of an attention call over ``lc``'s rows
    ``[:, rows]`` (none for an unquantised cache)."""
    if "k_scale" not in lc:
        return {}
    return {"k_scale": lc["k_scale"][:, rows], "v_scale": lc["v_scale"][:, rows]}


class DecoderLM:
    """Decoder-only LM for one config; parameters and caches are passed in."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe", "vlm") or cfg.attn is None or (
                (cfg.family == "moe") != (cfg.moe is not None)) or (
                cfg.attn.kind not in ("gqa", "mla")):
            raise NotImplementedError(
                f"{cfg.name}: the port covers dense, MoE and VLM decoders with GQA or MLA "
                "only; the other families are not ported yet (ROADMAP queue 1, item 12)")
        self.cfg = cfg
        self.padded_vocab = pad_vocab(cfg.vocab_size)
        self.mla = cfg.attn.kind == "mla"
        # the prefix every cached step masks with (JAX's decode_step, paged
        # step, prefill_chunk and mixed step pass the config's, always)
        self.step_prefix = cfg.prefix_len if cfg.bidirectional_prefix else 0

    # ------------------------------------------------------------------
    # parameters

    def param_defs(self) -> Dict:
        c, a = self.cfg, self.cfg.attn
        d, hd = c.d_model, a.head_dim
        H, KVH = a.n_heads, a.n_kv_heads
        layer: Dict = {
            "attn_norm": ParamDef((d,), init="ones", stacked=True),
            "mlp_norm": ParamDef((d,), init="ones", stacked=True),
        }
        if self.mla:
            rd, lr, vd = a.rope_head_dim, a.kv_lora_rank, a.vdim
            if a.q_lora_rank:
                # MLA's q_norm is the q-lora norm, [q_lora_rank] (Qwen3's is per head)
                layer["wq_a"] = ParamDef((d, a.q_lora_rank), stacked=True)
                layer["q_norm"] = ParamDef((a.q_lora_rank,), init="ones", stacked=True)
                layer["wq_b"] = ParamDef((a.q_lora_rank, H, hd + rd), stacked=True)
            else:
                layer["wq"] = ParamDef((d, H, hd + rd), stacked=True)
            layer["w_dkv"] = ParamDef((d, lr), stacked=True)
            layer["kv_norm"] = ParamDef((lr,), init="ones", stacked=True)
            layer["w_krope"] = ParamDef((d, rd), stacked=True)
            layer["w_uk"] = ParamDef((lr, H, hd), stacked=True)
            layer["w_uv"] = ParamDef((lr, H, vd), stacked=True)
            layer["wo"] = ParamDef((H, vd, d), stacked=True)
        else:
            layer["wq"] = ParamDef((d, H, hd), stacked=True)
            layer["wk"] = ParamDef((d, KVH, hd), stacked=True)
            layer["wv"] = ParamDef((d, KVH, hd), stacked=True)
            layer["wo"] = ParamDef((H, hd, d), stacked=True)
            if a.qk_norm:
                layer["q_norm"] = ParamDef((hd,), init="ones", stacked=True)
                layer["k_norm"] = ParamDef((hd,), init="ones", stacked=True)
        if c.moe is not None:
            layer["moe"] = moe.moe_defs(c)
        else:
            layer["w_gate"] = ParamDef((d, c.d_ff), stacked=True)
            layer["w_up"] = ParamDef((d, c.d_ff), stacked=True)
            layer["w_down"] = ParamDef((c.d_ff, d), stacked=True)
        return {
            "embed": ParamDef((self.padded_vocab, d), scale=0.02),
            "final_norm": ParamDef((d,), init="ones"),
            "unembed": ParamDef((self.padded_vocab, d), scale=0.02),
            "layers": layer,
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
        """Ring cache: k/v ``[nL, B, L, KVH, hd]`` in ``dtype``, or int8 with
        ``k_scale``/``v_scale`` ``[nL, B, L, KVH]`` in ``dtype`` under
        ``cfg.kv_quant``; pos ``[B, L]``, -1 unwritten.  An MLA cache holds
        ``ckv [nL, B, L, kv_lora_rank]`` and ``krope [nL, B, L,
        rope_head_dim]`` in ``dtype`` instead of k/v, whatever
        ``kv_quant`` says (it is already rank-compressed), as in JAX."""
        c, a = self.cfg, self.cfg.attn
        device = resolve_device(device)
        if self.mla:
            rows = (c.n_layers, batch, cache_len)
            return {"ckv": torch.zeros((*rows, a.kv_lora_rank), dtype=dtype, device=device),
                    "krope": torch.zeros((*rows, a.rope_head_dim), dtype=dtype,
                                         device=device),
                    "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                                      device=device)}
        return self._kv_leaves((c.n_layers, batch, cache_len, a.n_kv_heads), dtype, device,
                               pos=(batch, cache_len))

    def _kv_leaves(self, rows_shape: Tuple[int, ...], dtype: torch.dtype,
                   device: torch.device, pos: Tuple[int, int]) -> Dict:
        """Zeroed k/v ``[*rows_shape, hd]`` (int8 codes and ``rows_shape``
        scales under ``kv_quant``) and positions ``pos`` at -1."""
        hd = self.cfg.attn.head_dim
        kv_dtype = torch.int8 if self.cfg.kv_quant else dtype
        out = {"k": torch.zeros((*rows_shape, hd), dtype=kv_dtype, device=device),
               "v": torch.zeros((*rows_shape, hd), dtype=kv_dtype, device=device)}
        if self.cfg.kv_quant:
            out["k_scale"] = torch.zeros(rows_shape, dtype=dtype, device=device)
            out["v_scale"] = torch.zeros(rows_shape, dtype=dtype, device=device)
        out["pos"] = torch.full(pos, -1, dtype=torch.int32, device=device)
        return out

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> Dict:
        """Paged KV pool shared by every slot (the engine adds the block
        table ``bt [B, MAXB]``):

            k/v : [nL, num_blocks + 1, block_size, KVH, hd]
            pos : [num_blocks + 1, block_size]  absolute position, -1 unwritten

        and under ``cfg.kv_quant`` int8 k/v with ``k_scale``/``v_scale``
        ``[nL, num_blocks + 1, block_size, KVH]`` in ``dtype``.

        Block ``num_blocks`` is a trash block that no table ever names: the
        writes the JAX package drops (``mode="drop"`` at an out-of-range
        block) land there instead, since an in-place index write has no drop
        mode.  Compare ``pos[:num_blocks]``.

        An MLA model has no paged pool, as in JAX: it raises."""
        if self.mla:
            raise NotImplementedError(
                "paged KV does not support MLA's compressed cache (neither does the JAX "
                "package's init_paged_cache); MLA serves on the contiguous ring")
        c, a = self.cfg, self.cfg.attn
        device = resolve_device(device)
        return self._kv_leaves((c.n_layers, num_blocks + 1, block_size, a.n_kv_heads),
                               dtype, device, pos=(num_blocks + 1, block_size))

    # ------------------------------------------------------------------
    # layers

    def _qkv(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor, rope):
        """x: [B,T,d] -> q [B,T,H,hd], k/v [B,T,KVH,hd] with RoPE applied
        (``rope`` is the forward's ``cm.rope_table``).  Under ``qk_norm`` q
        and k are RMS-normalised per head before RoPE, as JAX's
        ``_qkv_gqa``: one K5 call each over their ``[B*T*heads, hd]`` rows."""
        a = self.cfg.attn
        B, T, d = x.shape
        q = (x @ lp["wq"].reshape(d, -1)).view(B, T, a.n_heads, a.head_dim)
        k = (x @ lp["wk"].reshape(d, -1)).view(B, T, a.n_kv_heads, a.head_dim)
        v = (x @ lp["wv"].reshape(d, -1)).view(B, T, a.n_kv_heads, a.head_dim)
        if a.qk_norm:
            q = cm.rms_norm(q, lp["q_norm"], self.cfg.norm_eps)
            k = cm.rms_norm(k, lp["k_norm"], self.cfg.norm_eps)
        q = cm.apply_rope(q, positions, a.rope_theta, rope)
        k = cm.apply_rope(k, positions, a.rope_theta, rope)
        return q, k, v

    def _attn_decode(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                     lc: Dict, pos_arr: torch.Tensor, rows: torch.Tensor, rope,
                     valid: Optional[torch.Tensor] = None,
                     rows_limit: Optional[int] = None,
                     prefix_len: int = 0) -> torch.Tensor:
        """Write the new K/V rows at ``rows`` [B,T] of the layer cache ``lc``
        (``_layer``; in place), then attend.  ``pos_arr`` [B,L] already
        holds the new rows' positions.

        ``valid`` [B,T] marks the columns to write: a column outside it
        writes its row's old value back, codes and scales alike
        (``_write_rows``).  ``rows_limit`` bounds the attended rows to the
        first ``rows_limit`` of the ring; the writes still land anywhere.
        Keys at positions below ``prefix_len`` are seen by every query.  An
        MLA model attends through :meth:`_attn_mla`."""
        if self.mla:
            return self._attn_mla(lp, x, positions, lc, pos_arr, rows, rope, valid,
                                  rows_limit, prefix_len)
        a = self.cfg.attn
        B, T, _ = x.shape
        q, k_new, v_new = self._qkv(lp, x, positions, rope)
        bidx = torch.arange(B, device=x.device)[:, None]
        _write_rows(lc, _stored(lc, k_new, v_new), bidx, rows, valid)
        R = pos_arr.shape[1] if rows_limit is None else rows_limit
        out = spec_verify_attn(q, lc["k"][:, :R], lc["v"][:, :R], positions,
                               pos_arr[:, :R], window=a.window, prefix_len=prefix_len,
                               **_scales(lc, slice(R)))
        return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)

    def _mla_proj(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor, rope):
        """x: [B,T,d] -> (q_nope [B,T,H,hd], q_rope [B,T,H,rd] with RoPE,
        ckv [B,T,kv_lora_rank] RMS-normed, krope [B,T,rd] with RoPE), as
        JAX's ``_mla_proj``.  The q-lora norm and ``kv_norm`` are K5 calls
        over ``[B*T, q_lora_rank]`` and ``[B*T, kv_lora_rank]`` rows."""
        a, eps = self.cfg.attn, self.cfg.norm_eps
        B, T, d = x.shape
        if a.q_lora_rank:
            qa = cm.rms_norm(x @ lp["wq_a"], lp["q_norm"], eps)
            q = qa @ lp["wq_b"].reshape(a.q_lora_rank, -1)
        else:
            q = x @ lp["wq"].reshape(d, -1)
        q = q.view(B, T, a.n_heads, a.head_dim + a.rope_head_dim)
        q_nope = q[..., :a.head_dim]
        q_rope = cm.apply_rope(q[..., a.head_dim:], positions, a.rope_theta, rope)
        ckv = cm.rms_norm(x @ lp["w_dkv"], lp["kv_norm"], eps)
        krope = cm.apply_rope((x @ lp["w_krope"])[:, :, None], positions, a.rope_theta,
                              rope)[:, :, 0]
        return q_nope, q_rope, ckv, krope

    def _mla_qkv(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor, rope):
        """MLA's full-sequence q, k, v for K4, as JAX's ``_attn_full`` and
        ``prefill_flash`` MLA branches build them: ``k_nope = ckv @ W_uk``
        and ``v = ckv @ W_uv`` per head, q ``[B,T,H,hd+rd]`` = (q_nope,
        q_rope), k ``[B,T,H,hd+rd]`` = (k_nope, krope broadcast over the
        heads), both materialised (K4 reads contiguous rows), v ``[B,T,H,
        vd]``.  Returns (q, k, v, ckv, krope), the last two as the cache
        stores them before the cast."""
        a = self.cfg.attn
        q_nope, q_rope, ckv, krope = self._mla_proj(lp, x, positions, rope)
        k_nope = torch.einsum("btl,lhk->bthk", ckv, lp["w_uk"])
        vv = torch.einsum("btl,lhv->bthv", ckv, lp["w_uv"]).contiguous()
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, krope[:, :, None].expand(*k_nope.shape[:3], a.rope_head_dim)],
                      dim=-1)
        return q, k, vv, ckv, krope

    def _mla_scale(self) -> float:
        """MLA's softmax scale, ``1/sqrt(head_dim + rope_head_dim)``."""
        return 1.0 / math.sqrt(self.cfg.attn.head_dim + self.cfg.attn.rope_head_dim)

    def _attn_mla(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor, lc: Dict,
                  pos_arr: torch.Tensor, rows: torch.Tensor, rope,
                  valid: Optional[torch.Tensor], rows_limit: Optional[int],
                  prefix_len: int = 0) -> torch.Tensor:
        """MLA's ring attention (JAX's ``_attn_decode`` MLA branch, product
        for product): write the new ``ckv``/``krope`` rows at ``rows`` of
        ``lc`` (in place, ``valid`` as in :meth:`_attn_decode`), then the
        absorbed attention over the first ``rows_limit`` rows:
        ``q_nope @ W_uk`` scored against ``ckv`` plus ``q_rope`` against
        ``krope``, the two summed in the cache's dtype, then scaled and
        softmaxed in fp32 with masked scores at -1e30 (a row that sees no
        key takes the mean of the ``ckv`` rows, as in JAX), ``p`` cast to
        the cache's dtype times ``ckv``, expanded by ``W_uv`` and ``wo``."""
        a = self.cfg.attn
        B, T, _ = x.shape
        q_nope, q_rope, ckv_new, krope_new = self._mla_proj(lp, x, positions, rope)
        bidx = torch.arange(B, device=x.device)[:, None]
        _write_rows(lc, {"ckv": ckv_new.to(lc["ckv"].dtype),
                         "krope": krope_new.to(lc["krope"].dtype)}, bidx, rows, valid)
        R = pos_arr.shape[1] if rows_limit is None else rows_limit
        ckv, krope = lc["ckv"][:, :R], lc["krope"][:, :R]
        q_abs = torch.einsum("bthk,lhk->bthl", q_nope, lp["w_uk"])
        s1 = torch.einsum("bthl,bsl->bhts", q_abs, ckv)
        s2 = torch.einsum("bthr,bsr->bhts", q_rope, krope)
        scores = (s1 + s2).float() * self._mla_scale()
        mask = cm.position_mask(positions, pos_arr[:, :R], a.window, prefix_len)
        p = torch.softmax(scores.masked_fill(~mask[:, None], -1e30), dim=-1)
        o_lora = torch.einsum("bhts,bsl->bthl", p.to(ckv.dtype), ckv)
        out = torch.einsum("bthl,lhv->bthv", o_lora, lp["w_uv"])
        return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)

    def _attn_paged(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                    lc: Dict, pos: torch.Tensor, pb: torch.Tensor, off: torch.Tensor,
                    bt: torch.Tensor, rope,
                    cu_blocks: Optional[torch.Tensor],
                    wide: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                    ) -> torch.Tensor:
        """Write the new K/V rows (codes and scales in an int8 pool) at the
        physical addresses ``(pb, off)`` [B,T] of the layer pool ``lc``
        (``_layer``; in place; ``pb`` = the trash block for slots without a
        block there), then attend against the pool through the block table.

        ``wide = (b, t, q_pos)`` is the mixed launch's layout: ``x`` is
        ``[1, M, d]`` packed rows, and row m's query sits at ``(b[m],
        t[m])`` of a zeroed ``[B, Tm]`` batch whose positions ``q_pos``
        are -1 on every padding column, for the one attention call; each
        row's output is read back from the same place."""
        a = self.cfg.attn
        B, T, _ = x.shape
        q, k_new, v_new = self._qkv(lp, x, positions, rope)
        for name, t in _stored(lc, k_new, v_new).items():
            lc[name][pb, off] = t
        kw = dict(window=a.window, prefix_len=self.step_prefix, cu_blocks=cu_blocks,
                  **_scales(lc))
        if wide is None:
            out = paged_verify_attn(q, lc["k"], lc["v"], positions, pos, bt, **kw)
        else:
            b, t, q_pos = wide
            qw = q.new_zeros((*q_pos.shape, *q.shape[2:]))
            qw[b, t] = q[0]
            out = paged_verify_attn(qw, lc["k"], lc["v"], q_pos, pos, bt, **kw)[b, t]
        return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)

    def _attn_full(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                   prefix_len: int, rope) -> torch.Tensor:
        """Full-sequence self attention of the training forward (the JAX
        ``_attn_full(train=True)``, GQA or MLA: :meth:`_mla_qkv` at K4's
        (192, 128) head dims).  ``positions`` [B,T] serve as query and key
        positions."""
        a = self.cfg.attn
        B, T, _ = x.shape
        if self.mla:
            q, k, v, _, _ = self._mla_qkv(lp, x, positions, rope)
            out = flash_attn(q, k, v, positions, positions, window=a.window,
                             prefix_len=prefix_len, scale=self._mla_scale())
        else:
            q, k, v = self._qkv(lp, x, positions, rope)
            out = flash_attn(q, k, v, positions, positions, window=a.window,
                             prefix_len=prefix_len)
        return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, self.cfg.d_model)

    def _mlp(self, lp: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(out, the MoE load-balance aux loss; None for a dense MLP)."""
        if self.cfg.moe is not None:
            return moe.moe_forward(self.cfg, lp["moe"], x)
        return cm.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]), None

    def _layers(self, params: Dict, x: torch.Tensor, positions: torch.Tensor,
                attn: Callable, aux: Optional[list] = None) -> torch.Tensor:
        """The decoder stack; ``attn(lp, hn, layer, rope)`` is the attention
        block of one layer (ring or paged).  A MoE model appends each
        layer's aux loss to ``aux`` when given (the serving paths drop it)."""
        c = self.cfg
        # MLA's RoPE runs on its decoupled rope_head_dim columns only
        rope = cm.rope_table(positions, c.attn.rope_head_dim if self.mla else c.attn.head_dim,
                             c.attn.rope_theta)
        # one unbind per stacked weight: its backward stacks the layers'
        # gradients once, where indexing layer by layer would add a
        # full-size zero-padded gradient per layer
        layers = _unbind(params["layers"])
        for i in range(c.n_layers):
            lp = _pick(layers, i)
            hn = cm.rms_norm(x, lp["attn_norm"], c.norm_eps)
            x = x + attn(lp, hn, i, rope)
            m_out, l_aux = self._mlp(lp, cm.rms_norm(x, lp["mlp_norm"], c.norm_eps))
            x = x + m_out
            if aux is not None and l_aux is not None:
                aux.append(l_aux)
        return cm.rms_norm(x, params["final_norm"], c.norm_eps)

    def _ring_attn(self, cache: Dict, positions: torch.Tensor,
                   rows: torch.Tensor, prefix_len: int,
                   valid: Optional[torch.Tensor] = None,
                   rows_limit: Optional[int] = None) -> Callable:
        return lambda lp, hn, i, rope: self._attn_decode(
            lp, hn, positions, _layer(cache, i), cache["pos"], rows, rope, valid, rows_limit,
            prefix_len)

    def _embed(self, params: Dict, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor]) -> Tuple[torch.Tensor, int, int]:
        """The embedded tokens, after ``prefix_embeds [B, P, d]`` (cast to
        the embedding's dtype) when given; with the rows the prefix adds to
        each prompt (``cfg.prefix_len``, as JAX counts them) and the prefix
        the attention masks with (that many under ``bidirectional_prefix``,
        else 0; 0 without ``prefix_embeds``)."""
        x = cm.embed(tokens, params["embed"])
        if prefix_embeds is None:
            return x, 0, 0
        c = self.cfg
        if prefix_embeds.dim() != 3 or tuple(prefix_embeds.shape) != (
                tokens.shape[0], c.prefix_len, c.d_model) or not c.prefix_len:
            raise ValueError(f"{c.name}: prefix_embeds must be [B, {c.prefix_len}, "
                             f"{c.d_model}], got {tuple(prefix_embeds.shape)}")
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        return x, c.prefix_len, c.prefix_len if c.bidirectional_prefix else 0

    def _unembed(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return cm.unembed(x, params["unembed"], self.cfg.vocab_size)

    # ------------------------------------------------------------------
    # full-sequence forward (training / scoring)

    def forward(self, params: Dict, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T] -> (logits [B, P + T, V] fp32, aux), ``aux`` the MoE
        load-balance loss summed over the layers in fp32 (the JAX model's),
        a zero scalar for a dense model.  ``prefix_embeds [B, P, d]`` (a VLM)
        go before the tokens (``P`` is 0 without them).  No per-layer
        recompute: every layer's activations are kept for the backward."""
        x, _, prefix_len = self._embed(params, tokens, prefix_embeds)
        B, T = x.shape[:2]
        dev = tokens.device
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        aux = []
        x = self._layers(params, x, positions,
                         lambda lp, hn, i, rope: self._attn_full(lp, hn, positions, prefix_len,
                                                                 rope),
                         aux)
        # summed in layer order from zero, as JAX's scan carries it
        return (self._unembed(params, x),
                sum(aux, torch.zeros((), dtype=torch.float32, device=dev)))

    # ------------------------------------------------------------------
    # prefill: forward + cache population

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                prompt_lens: Optional[torch.Tensor] = None,
                prefix_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Right-padded prompts [B, Tp] -> (last-token logits [B, V], the
        cache written in place, seq_lens [B]).  Padded columns are written
        with position -1 and so are never attended.  ``prefix_embeds [B,
        P, d]`` (a VLM) fill rows ``0 .. P-1`` first; ``seq_lens`` then
        counts them (``prompt_lens + P``)."""
        x, P, prefix_len = self._embed(params, tokens, prefix_embeds)
        B, T = x.shape[:2]
        dev = tokens.device
        L = cache["pos"].shape[1]
        if prompt_lens is None:
            prompt_lens = torch.full((B,), tokens.shape[1], dtype=torch.int32, device=dev)
        total_lens = prompt_lens.to(torch.int32) + P
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        rows = (positions % L).long()
        bidx = torch.arange(B, device=dev)[:, None]
        cache["pos"][bidx, rows] = torch.where(positions < total_lens[:, None],
                                               positions, -1)
        x = self._layers(params, x, positions,
                         self._ring_attn(cache, positions, rows, prefix_len))
        last = x[torch.arange(B, device=dev), (total_lens - 1).long()]
        return self._unembed(params, last), cache, total_lens

    def prefill_flash(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                      prompt_lens: Optional[torch.Tensor] = None,
                      prefix_embeds: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """:meth:`prefill` with the attention of each layer run by K4 over
        the prompt's own K/V (padded rows at position -1, never attended)
        instead of over the cache; the K/V rows are then written to the ring
        once.  Same contract as :meth:`prefill` (``prefix_embeds`` too), and
        the same results over an unquantised ring.  Over an int8 ring K4 attends the unquantised rows
        and the quantised ones are written after it, as JAX's
        ``prefill_flash`` does, while :meth:`prefill` attends the quantised
        rows: the two differ by the quantisation there.  The contiguous ring
        only, as in JAX.

        An MLA model attends the prompt's per-head keys and values
        (:meth:`_mla_qkv`, K4 at (192, 128)), then writes its ``ckv`` and
        ``krope`` rows, cast to the cache's dtype, as JAX's MLA branch does;
        an MLA cache has no int8 form.  :meth:`prefill` attends in the
        absorbed form over ``ckv`` instead, so the two differ by the
        rounding of other products.  A padded column (position -1) attends
        nothing here and takes K4's zeros, where :meth:`prefill` lets it
        attend the prompt before it: a MoE layer that drops assignments can
        then route the two routes' real rows differently."""
        if "bt" in cache:
            raise NotImplementedError(
                "prefill_flash covers the contiguous ring only; the JAX package's "
                "prefill_flash has no paged form either")
        c = self.cfg
        x, P, prefix_len = self._embed(params, tokens, prefix_embeds)
        B, T = x.shape[:2]
        dev = tokens.device
        L = cache["pos"].shape[1]
        if prompt_lens is None:
            prompt_lens = torch.full((B,), tokens.shape[1], dtype=torch.int32, device=dev)
        total_lens = prompt_lens.to(torch.int32) + P
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        qk_pos = torch.where(positions < total_lens[:, None], positions, -1)
        rows = (positions % L).long()
        bidx = torch.arange(B, device=dev)[:, None]
        cache["pos"][bidx, rows] = qk_pos

        def attn(lp, hn, i, rope):
            lc = _layer(cache, i)
            if self.mla:
                q, k, v, ckv, krope = self._mla_qkv(lp, hn, positions, rope)
                out = flash_attn(q, k, v, qk_pos, qk_pos, window=c.attn.window,
                                 prefix_len=prefix_len, scale=self._mla_scale())
                new = {"ckv": ckv.to(lc["ckv"].dtype), "krope": krope.to(lc["krope"].dtype)}
            else:
                q, k, v = self._qkv(lp, hn, positions, rope)
                out = flash_attn(q, k, v, qk_pos, qk_pos, window=c.attn.window,
                                 prefix_len=prefix_len)
                new = _stored(lc, k, v)
            for name, t in new.items():
                lc[name][bidx, rows] = t
            return out.reshape(B, T, -1) @ lp["wo"].reshape(-1, c.d_model)

        x = self._layers(params, x, positions, attn)
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
                         self._ring_attn(cache, positions, rows, self.step_prefix))
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
        positions = ((seq_lens - 1)[:, None]
                     + torch.arange(tokens.shape[1], dtype=torch.int32,
                                    device=tokens.device)[None]).to(torch.int32)
        return self._paged_forward(params, tokens, cache, positions, cu_blocks)

    @staticmethod
    def _pool_rows(cache: Dict, bt: torch.Tensor, slots: torch.Tensor,
                   positions: torch.Tensor, valid: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The physical addresses ``(pb, off)`` of new rows at ``positions``
        through the table rows ``bt[slots]`` (``slots`` broadcasts against
        ``positions``), with their positions written into ``cache["pos"]``
        in place.  A row outside ``valid``, or at a table hole, goes to the
        trash block."""
        trash, bs = cache["pos"].shape[0] - 1, cache["pos"].shape[1]
        blk = (positions // bs).clamp(0, bt.shape[1] - 1).long()
        off = (positions % bs).long()
        pb = bt[slots, blk]
        dropped = pb < 0 if valid is None else (pb < 0) | ~valid
        pb = torch.where(dropped, trash, pb).long()
        cache["pos"][pb, off] = (positions if valid is None
                                 else torch.where(valid, positions, -1))
        return pb, off

    def _paged_forward(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                       positions: torch.Tensor, cu_blocks: Optional[torch.Tensor],
                       valid: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, Dict]:
        """The decoder over the paged pool at ``positions`` [B,T], writing
        each column through its slot's table; a column outside ``valid``
        [B,T], or at a table hole, writes into the trash block."""
        bt = cache["bt"]                                        # [B, MAXB]
        slots = torch.arange(bt.shape[0], device=bt.device)[:, None]
        pb, off = self._pool_rows(cache, bt, slots, positions, valid)

        def attn(lp, hn, i, rope):
            return self._attn_paged(lp, hn, positions, _layer(cache, i), cache["pos"],
                                    pb, off, bt, rope, cu_blocks)

        x = self._layers(params, cm.embed(tokens, params["embed"]), positions, attn)
        return self._unembed(params, x), cache

    def decode_step_mixed(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                          seq_lens: torch.Tensor, chunk_slot: int,
                          chunk_tokens: torch.Tensor, chunk_start: int,
                          chunk_limit: int, chunk_bt_row: torch.Tensor,
                          verify_len: int, cu_blocks: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, Dict]:
        """One mixed verify+chunk launch against the paged pool: the port of
        the JAX ``decode_step_mixed``.

        Row ``chunk_slot`` carries a prefill chunk (``chunk_tokens`` at
        absolute positions ``chunk_start ..``, those at or beyond
        ``chunk_limit`` bucket padding), read and written through
        ``chunk_bt_row``, the slot's host table row; every other row
        carries its verify feed, the first ``verify_len`` columns of
        ``tokens`` at ``seq_lens - 1 ..``.  Both query kinds ride one
        paged attention call per layer (K3 with ``cu_blocks``, which must
        describe ``bt`` with the chunk row patched in).

        The JAX function pads every slot to ``Tm`` columns for the whole
        layer (``Tm = max(T, CB)``, ``T`` the width of ``tokens``, ``CB``
        the chunk's bucket; its engine passes them padded with zeros to
        ``max(s + 1, CB)``).  For a dense model only the rows that carry a
        token go through the embedding, K5, RoPE and the products here,
        packed into one ``[1, M]`` sequence (each other slot's
        ``verify_len`` columns and the chunk's ``n`` real columns): the
        attention alone widens to ``[B, Tm]``, ``Tm = max(verify_len, n)``,
        with position -1 on every padding column (it sees nothing and
        writes nowhere).  A dense row's value does not depend on the rows
        beside it, so the values are JAX's; only the roundings of the
        products differ, which run on another number of rows.  A MoE
        layer's do depend on them (the padding rows are routed and take
        expert capacity), so a MoE model carries JAX's ``[B, Tm]`` layout,
        padding tokens and all, through every layer
        (:meth:`_decode_step_mixed_wide`).

        The device table ``cache["bt"]`` is not patched: the pending slot's
        row stays -1 until its final chunk commits, and the patched table
        is only the attention's operand.  The chunk slot writes no verify
        rows (flush-then-step writes them into the trash block).  Returns
        (logits [B, verify_len, V] of the verify columns, the cache written
        in place); the chunk row's logits mean nothing."""
        B = seq_lens.shape[0]
        dev = seq_lens.device
        n = min(int(chunk_tokens.shape[0]), chunk_limit - chunk_start)
        if n < 1 or not 0 <= chunk_slot < B:
            raise ValueError(f"no chunk rows: slot {chunk_slot} of {B}, positions "
                             f"[{chunk_start}, {chunk_limit}) in a {chunk_tokens.shape[0]} bucket")
        bt_eff = cache["bt"].clone()
        bt_eff[chunk_slot] = chunk_bt_row
        if self.cfg.moe is not None:
            return self._decode_step_mixed_wide(params, tokens, cache, seq_lens, chunk_slot,
                                                chunk_tokens, chunk_start, chunk_limit,
                                                bt_eff, verify_len, cu_blocks)
        # the packed layout, built on the host: row m is column t[m] of slot b[m]
        counts = np.full(B, verify_len)
        counts[chunk_slot] = n
        starts = np.cumsum(counts) - counts
        b_np = np.repeat(np.arange(B), counts)
        t_np = np.arange(len(b_np)) - np.repeat(starts, counts)
        # the verify logits' rows (the chunk slot's: its rows, to fill the shape)
        v_np = starts[:, None] + np.minimum(np.arange(verify_len)[None], counts[:, None] - 1)
        M = len(b_np)
        idx = torch.from_numpy(np.concatenate([b_np, t_np, v_np.ravel()])).to(dev)
        b, t, vrows = idx[:M], idx[M:2 * M], idx[2 * M:]
        c0 = int(starts[chunk_slot])
        toks = tokens[b, t.clamp(max=tokens.shape[1] - 1)]
        toks[c0:c0 + n] = chunk_tokens[:n]
        positions = (seq_lens[b] - 1 + t).to(torch.int32)
        positions[c0:c0 + n] = chunk_start + t[c0:c0 + n].to(torch.int32)
        q_pos = torch.full((B, max(verify_len, n)), -1, dtype=torch.int32, device=dev)
        q_pos[b, t] = positions
        positions = positions[None]
        pb, off = self._pool_rows(cache, bt_eff, b[None], positions)

        def attn(lp, hn, i, rope):
            return self._attn_paged(lp, hn, positions, _layer(cache, i), cache["pos"],
                                    pb, off, bt_eff, rope, cu_blocks, wide=(b, t, q_pos))

        x = self._layers(params, cm.embed(toks[None], params["embed"]), positions, attn)
        return self._unembed(params, x[0, vrows].view(B, verify_len, -1)), cache

    def _decode_step_mixed_wide(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                                seq_lens: torch.Tensor, chunk_slot: int,
                                chunk_tokens: torch.Tensor, chunk_start: int,
                                chunk_limit: int, bt_eff: torch.Tensor, verify_len: int,
                                cu_blocks: Optional[torch.Tensor],
                                ) -> Tuple[torch.Tensor, Dict]:
        """:meth:`decode_step_mixed` in JAX's layout: every slot's ``Tm``
        columns through every layer, ``tokens`` and ``chunk_tokens``
        zero-padded to ``Tm = max(T, CB)``; a verify column at or past
        ``verify_len``, and a chunk column at or past ``chunk_limit``, sits
        at position -1 (attends nothing, writes into the trash block) but
        is embedded, normed and routed like any other row."""
        B, T = tokens.shape
        dev = seq_lens.device
        CB = int(chunk_tokens.shape[0])
        Tm = max(T, CB)
        toks = tokens.new_zeros((B, Tm))
        toks[:, :T] = tokens
        toks[chunk_slot] = 0
        toks[chunk_slot, :CB] = chunk_tokens.to(toks.dtype)
        col = torch.arange(Tm, dtype=torch.int32, device=dev)[None]
        positions = torch.where(col < verify_len, (seq_lens - 1)[:, None] + col,
                                -1).to(torch.int32)
        cpos = chunk_start + col[0]
        positions[chunk_slot] = torch.where(cpos < chunk_limit, cpos, -1)
        slots = torch.arange(B, device=dev)[:, None]
        pb, off = self._pool_rows(cache, bt_eff, slots, positions, positions >= 0)

        def attn(lp, hn, i, rope):
            return self._attn_paged(lp, hn, positions, _layer(cache, i), cache["pos"],
                                    pb, off, bt_eff, rope, cu_blocks)

        x = self._layers(params, cm.embed(toks, params["embed"]), positions, attn)
        return self._unembed(params, x[:, :verify_len]), cache

    # ------------------------------------------------------------------
    # chunked prefill (prefix extension)

    def prefill_chunk(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                      offset: torch.Tensor, limit: torch.Tensor,
                      rows_limit: Optional[int] = None,
                      cu_blocks: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Dict]:
        """One prefill chunk: write ``tokens`` [B, T] at absolute positions
        ``offset .. offset+T-1`` ([B] each), attending over the prefix
        already in the cache plus the chunk itself.  Returns (logits [B, T,
        V], the cache written in place).

        Positions at or beyond ``limit`` [B] are bucket padding and change
        no row of the cache.  The ring has no row to drop them into, so a
        padded column writes its row's old K, V and position back; that
        covers the ragged final chunk whose padded tail wraps onto row 0.
        The paged pool sends them, and table holes, to its trash block.  A
        chunk query at position p sees exactly the keys at positions <= p,
        which makes the chunked cache equal to a whole-prompt prefill's.

        ``rows_limit`` bounds the attended ring rows (every visible key of
        a chunk lives below row ``offset + T`` until the ring wraps);
        ``cu_blocks [B + 1]`` selects the ragged kernel K3 on the paged
        path, as in :meth:`decode_step`."""
        B, T = tokens.shape
        positions = (offset[:, None].to(torch.int32)
                     + torch.arange(T, dtype=torch.int32, device=tokens.device)[None])
        valid = positions < limit[:, None]
        if "bt" in cache:
            return self._paged_forward(params, tokens, cache, positions, cu_blocks, valid)
        L = cache["pos"].shape[1]
        if T > L:
            raise ValueError(f"a chunk of {T} rows does not fit a ring of {L}")
        rows = (positions % L).long()
        bidx = torch.arange(B, device=tokens.device)[:, None]
        cache["pos"][bidx, rows] = torch.where(valid, positions, cache["pos"][bidx, rows])
        x = self._layers(params, cm.embed(tokens, params["embed"]), positions,
                         self._ring_attn(cache, positions, rows, self.step_prefix, valid,
                                         rows_limit))
        return self._unembed(params, x), cache

    @staticmethod
    def commit(cache_out: Dict, accept_idx: torch.Tensor) -> Dict:
        """Attention-cache rollback is a pure length update done by the
        engine (stale ring rows are overwritten before they can be
        attended)."""
        return cache_out
