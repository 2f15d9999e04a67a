"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) language model: the
port of ``repro.models.mamba2.Mamba2LM`` for serving.

Prefill and the no-grad ``forward`` run the chunked SSD algorithm (an
intra-chunk "attention-like" quadratic term and a diagonal recurrence
across chunks) through ``kernels.ops.ssd_chunked``: the kernel K6 for CUDA
tensors, one launch per layer for every chunk; its plain version for CPU
tensors.  Decode keeps a recurrent state per layer, ``state [nL,B,H,P,N]``
fp32 plus causal-conv buffers of the last ``d_conv - 1`` raw rows, and runs
the per-token recurrence in torch ops, as the JAX model runs it in jnp.

Speculative decoding on an SSM has no KV rows to mask: ``decode_step``
checkpoints the state and the conv buffers after *every* fed position, and
``commit`` picks, per request, the checkpoint at its accept index, so a
rollback is exact.  ``prefill`` writes the cache in place and so does
``decode_step`` for the all-positions state; ``commit`` returns the
selected leaves.

``forward`` also trains: under autograd the scan is K6's forward and its
hand-written backward on the card (``kernels.ops.ssd_chunked``), and
A_log, dt_bias, the convolutions and the projections get their gradients
through torch's own autograd, as the JAX model's do through ``jax.grad``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, pad_vocab
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import ssd_chunked
from repro_torch.models import common as cm
from repro_torch.models.common import ParamDef


class Mamba2LM:
    """Mamba-2 LM for one config; parameters and caches are passed in."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "ssm" or cfg.ssm is None:
            raise ValueError(f"{cfg.name}: Mamba2LM takes an ssm config")
        self.cfg = cfg
        s = cfg.ssm
        self.d_in = s.expand * cfg.d_model
        self.nheads = self.d_in // s.head_dim
        self.bc = s.n_groups * s.d_state         # B/C projection width (each)
        self.padded_vocab = pad_vocab(cfg.vocab_size)

    # ------------------------------------------------------------------
    # parameters

    def param_defs(self) -> Dict:
        c, s = self.cfg, self.cfg.ssm
        d, din, bc, H = c.d_model, self.d_in, self.bc, self.nheads
        layer = {
            "norm": ParamDef((d,), init="ones", stacked=True),
            "in_z": ParamDef((d, din), stacked=True),
            "in_x": ParamDef((d, din), stacked=True),
            "in_b": ParamDef((d, bc), stacked=True),
            "in_c": ParamDef((d, bc), stacked=True),
            "in_dt": ParamDef((d, H), stacked=True),
            "dt_bias": ParamDef((H,), init="zeros", stacked=True),
            "A_log": ParamDef((H,), init="zeros", stacked=True),
            "D": ParamDef((H,), init="ones", stacked=True),
            "conv_x": ParamDef((s.d_conv, din), scale=0.5, stacked=True),
            "conv_x_b": ParamDef((din,), init="zeros", stacked=True),
            "conv_b": ParamDef((s.d_conv, bc), scale=0.5, stacked=True),
            "conv_b_b": ParamDef((bc,), init="zeros", stacked=True),
            "conv_c": ParamDef((s.d_conv, bc), scale=0.5, stacked=True),
            "conv_c_b": ParamDef((bc,), init="zeros", stacked=True),
            "norm_y": ParamDef((din,), init="ones", stacked=True),
            "out": ParamDef((din, d), stacked=True),
        }
        return {
            "embed": ParamDef((self.padded_vocab, d), scale=0.02),
            "final_norm": ParamDef((d,), init="ones"),
            "unembed": ParamDef((self.padded_vocab, d), scale=0.02),
            "layers": layer,
        }

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cuda") -> Dict:
        """Seeded parameters on ``device`` (the generator must live there),
        with the JAX init's ``dt_bias`` (softplus(dt_bias) spans 1e-3 to
        1e-1 over the heads) and ``A_log`` (log of 1 to 16)."""
        device = resolve_device(device)
        p = cm.init_params(self.param_defs(), generator, self.cfg.n_layers, dtype, device)
        nL, H = self.cfg.n_layers, self.nheads
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H))
        inv_softplus = torch.log(torch.expm1(dt))
        # real [nL, H] tensors, not expanded views: the optimizer updates them in place
        p["layers"]["dt_bias"] = inv_softplus.repeat(nL, 1).to(dtype=dtype, device=device)
        p["layers"]["A_log"] = torch.log(torch.linspace(1.0, 16.0, H)).repeat(nL, 1).to(
            dtype=dtype, device=device)
        return p

    # ------------------------------------------------------------------
    # recurrent cache

    def init_cache(self, batch: int, cache_len: int = 0,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> Dict:
        """state fp32 [nL,B,H,P,N]; conv buffers [nL,B,d_conv-1,ch] in
        ``dtype``.  ``cache_len`` is unused: the state does not grow."""
        c, s = self.cfg, self.cfg.ssm
        device = resolve_device(device)
        nL, w = c.n_layers, s.d_conv - 1
        return {
            "state": torch.zeros((nL, batch, self.nheads, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device),
            "conv_x": torch.zeros((nL, batch, w, self.d_in), dtype=dtype, device=device),
            "conv_b": torch.zeros((nL, batch, w, self.bc), dtype=dtype, device=device),
            "conv_c": torch.zeros((nL, batch, w, self.bc), dtype=dtype, device=device),
        }

    # ------------------------------------------------------------------
    # pieces

    @staticmethod
    def _conv_full(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv over time, then SiLU.  x: [B,T,C]; w: [K,C]."""
        K, T = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, K - 1, 0))
        out = sum(xp[:, i:i + T] * w[i] for i in range(K))
        return F.silu(out + b)

    @staticmethod
    def _proj_in(lp: Dict, x: torch.Tensor):
        return (x @ lp["in_z"], x @ lp["in_x"], x @ lp["in_b"], x @ lp["in_c"],
                x @ lp["in_dt"])

    def _ssd_chunked(self, lp: Dict, xh, B_, C_, dt, h0):
        """xh [B,T,H,P]; B_/C_ [B,T,G,N]; dt [B,T,H] (>= 0, softplus applied,
        zeroed on padding); h0 [B,H,P,N], or None for a zero state.  Returns
        (y [B,T,H,P] fp32, h_final)."""
        A = torch.exp(lp["A_log"].float())
        return ssd_chunked(xh, B_, C_, dt, A, h0, self.cfg.ssm.chunk)

    def _gate_out(self, lp: Dict, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
        """The D skip, the SiLU(z) gate, the ``norm_y`` RMSNorm (K5 at d_in)
        and the output projection.  y, xh: [B,T,H,P]."""
        B, T = y.shape[:2]
        y = y + lp["D"].float()[None, None, :, None] * xh.float()
        y = y.reshape(B, T, self.d_in).to(dtype)
        y = cm.rms_norm(y * F.silu(z), lp["norm_y"], self.cfg.norm_eps)
        return y @ lp["out"]

    def _layer_full(self, lp: Dict, x: torch.Tensor, h0: Optional[torch.Tensor],
                    dt_mask: Optional[torch.Tensor] = None):
        """Full-sequence mixer.  x: [B,T,d] (normed).  Returns (out, h_final,
        the raw conv inputs (x, b, c) for a prefill's conv buffers)."""
        s = self.cfg.ssm
        B, T, _ = x.shape
        z, xc_raw, bb_raw, cc_raw, dt = self._proj_in(lp, x)
        xc = self._conv_full(xc_raw, lp["conv_x"], lp["conv_x_b"])
        bb = self._conv_full(bb_raw, lp["conv_b"], lp["conv_b_b"])
        cc = self._conv_full(cc_raw, lp["conv_c"], lp["conv_c_b"])
        dt = F.softplus(dt.float() + lp["dt_bias"].float())
        if dt_mask is not None:
            dt = dt * dt_mask
        xh = xc.view(B, T, self.nheads, s.head_dim)
        y, h_fin = self._ssd_chunked(lp, xh, bb.view(B, T, s.n_groups, s.d_state),
                                     cc.view(B, T, s.n_groups, s.d_state), dt, h0)
        return self._gate_out(lp, y, xh, z, x.dtype), h_fin, (xc_raw, bb_raw, cc_raw)

    def _layers(self, params: Dict):
        layers = {k: v.unbind(0) for k, v in params["layers"].items()}
        for i in range(self.cfg.n_layers):
            yield i, {k: v[i] for k, v in layers.items()}

    def _unembed(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        x = cm.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return cm.unembed(x, params["unembed"], self.cfg.vocab_size)

    # ------------------------------------------------------------------
    # full-sequence forward (scoring)

    def forward(self, params: Dict, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T] -> (logits [B, T, V] fp32, the zero aux loss);
        differentiable in the parameters.  Every activation is kept for the
        backward (the JAX model's per-layer remat has no counterpart)."""
        if prefix_embeds is not None:
            raise NotImplementedError(
                "modality prefixes (VLM) are not ported yet (ROADMAP queue 1, item 12)")
        c = self.cfg
        x = cm.embed(tokens, params["embed"])
        for _, lp in self._layers(params):
            out, _, _ = self._layer_full(lp, cm.rms_norm(x, lp["norm"], c.norm_eps), None)
            x = x + out
        return (self._unembed(params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # ------------------------------------------------------------------
    # prefill: forward + state and conv buffers

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                prompt_lens: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Right-padded prompts [B, T] -> (last-token logits [B, V], the
        cache written in place, prompt_lens [B]).  Positions at or past a
        prompt's length get dt = 0, so they neither decay nor feed the
        state, which is exact per request; the conv buffers take each
        prompt's last ``d_conv - 1`` valid raw rows, zeros before position
        0."""
        c, s = self.cfg, self.cfg.ssm
        B, T = tokens.shape
        dev = tokens.device
        if prompt_lens is None:
            prompt_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        prompt_lens = prompt_lens.to(torch.int32)
        pos = torch.arange(T, device=dev)[None]
        dt_mask = (pos < prompt_lens[:, None]).float()[..., None]          # [B,T,1]
        w = s.d_conv - 1
        rows = prompt_lens[:, None].long() - w + torch.arange(w, device=dev)[None]  # [B,w]
        gather = rows.clamp(0, T - 1)
        valid = (rows >= 0)[..., None]                                      # [B,w,1]
        bidx = torch.arange(B, device=dev)[:, None]
        x = cm.embed(tokens, params["embed"])
        for i, lp in self._layers(params):
            out, h_fin, raws = self._layer_full(lp, cm.rms_norm(x, lp["norm"], c.norm_eps),
                                                None, dt_mask)
            cache["state"][i] = h_fin
            for name, raw in zip(("conv_x", "conv_b", "conv_c"), raws):
                cache[name][i] = torch.where(valid, raw[bidx, gather], 0).to(cache[name].dtype)
            x = x + out
        last = x[torch.arange(B, device=dev), (prompt_lens - 1).long()]
        return self._unembed(params, last), cache, prompt_lens

    # ------------------------------------------------------------------
    # incremental decode with per-position checkpoints

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    seq_lens: torch.Tensor,
                    cu_blocks: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, T] (the last committed token, then T-1 drafts) ->
        (logits [B, T, V], the out-cache).  The out-cache holds ``state``
        (all T applied; the input cache's tensor, written in place) and the
        checkpoints after every position: ``state_ckpt [nL,B,T,H,P,N]`` fp32
        and ``conv_*_ckpt [nL,B,T,d_conv-1,ch]``.  ``seq_lens`` is not read
        (the state carries the position); a recurrent cache has no block
        table, so ``cu_blocks`` must be None."""
        if cu_blocks is not None:
            raise ValueError("an SSM cache has no block table: cu_blocks must be None")
        c, s = self.cfg, self.cfg.ssm
        B, T = tokens.shape
        dev = tokens.device
        w = s.d_conv - 1
        H, Pd, N, G = self.nheads, s.head_dim, s.d_state, s.n_groups
        nL = c.n_layers
        state_ckpt = torch.empty((nL, B, T, H, Pd, N), dtype=torch.float32, device=dev)
        conv_ckpt = {name: torch.empty((nL, B, T, w, cache[name].shape[-1]),
                                       dtype=cache[name].dtype, device=dev)
                     for name in ("conv_x", "conv_b", "conv_c")}
        # the w raw rows that end at each new position, in [cached w | T new]
        idx = (torch.arange(T, device=dev)[:, None] + 1
               + torch.arange(w, device=dev)[None])                         # [T, w]
        x = cm.embed(tokens, params["embed"])
        for i, lp in self._layers(params):
            hn = cm.rms_norm(x, lp["norm"], c.norm_eps)
            z, xc_raw, bb_raw, cc_raw, dt = self._proj_in(lp, hn)
            conv = {}
            for name, raw in (("conv_x", xc_raw), ("conv_b", bb_raw), ("conv_c", cc_raw)):
                full = torch.cat([cache[name][i], raw.to(cache[name].dtype)], dim=1)
                wk, bk = lp[name], lp[name + "_b"]
                K = wk.shape[0]
                out = sum(full[:, w - (K - 1) + k: w - (K - 1) + k + T] * wk[k]
                          for k in range(K))
                conv[name] = F.silu(out + bk)
                conv_ckpt[name][i] = full[:, idx]
            dt = F.softplus(dt.float() + lp["dt_bias"].float())            # [B,T,H]
            A = torch.exp(lp["A_log"].float())
            xh = conv["conv_x"].reshape(B, T, H, Pd).float()
            Bm = conv["conv_b"].reshape(B, T, G, N).repeat_interleave(H // G, dim=2).float()
            Cm = conv["conv_c"].reshape(B, T, G, N).repeat_interleave(H // G, dim=2).float()
            decay = torch.exp(-dt * A)                                      # [B,T,H]
            contrib = (dt[..., None] * xh)[..., None] * Bm[:, :, :, None, :]  # [B,T,H,P,N]
            hstate = cache["state"][i]
            for t in range(T):
                ck = state_ckpt[i, :, t]
                torch.mul(hstate, decay[:, t, :, None, None], out=ck)
                ck += contrib[:, t]
                hstate = ck
            cache["state"][i] = hstate
            y = torch.einsum("bthn,bthpn->bthp", Cm, state_ckpt[i])
            x = x + self._gate_out(lp, y, xh, z, x.dtype)
        out_cache = {"state": cache["state"], "state_ckpt": state_ckpt,
                     **{name + "_ckpt": t for name, t in conv_ckpt.items()}}
        return self._unembed(params, x), out_cache

    @staticmethod
    def commit(cache_out: Dict, accept_idx: torch.Tensor) -> Dict:
        """The checkpoint at ``accept_idx`` [B] of every request: a gather
        over the T axis, equal to the JAX model's one-hot sum."""
        B = accept_idx.shape[0]
        bidx = torch.arange(B, device=accept_idx.device)
        sel = accept_idx.long()
        return {name: cache_out[name + "_ckpt"][:, bidx, sel]
                for name in ("state", "conv_x", "conv_b", "conv_c")}
