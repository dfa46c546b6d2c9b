"""Selective SSM (Mamba-style) block, the SSM half of hymba's hybrid heads
(port of ``repro.nn.ssm``).

Hymba (arXiv:2411.13676) runs attention heads and mamba heads in parallel
within each layer and averages their re-normalized outputs.  This module is
the mamba head: in-projection with gate, causal depthwise conv,
data-dependent (dt, B, C) selective scan over a (d_inner, d_state) float32
state, gated out-projection.  The four projections are ``dense`` leaves
(approximable); the recurrence is exact float32 elementwise work.

The reference runs the scan as a ``lax.scan`` and has no Pallas kernel for
it, so here it is plain PyTorch on every device: a loop over time, one
``addcmul`` a step, with the decay and input terms of ``SCAN_CHUNK`` steps
computed ahead of the loop (bounded memory at any length).  The same scan
gives the prefill output and the final state (:func:`ssm_scan`), where the
reference recomputes the state in a second scan.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.approx_linear import dense, init_dense

#: time steps whose decay and input terms are materialized at once:
#: (B, SCAN_CHUNK, d_inner, d_state) float32 each
SCAN_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int  # expansion (hymba: 2 * d_model over the ssm heads)
    d_state: int = 16
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    conv_kernel: int = 4

    @property
    def dtr(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def init_ssm(cfg: SSMConfig, *, generator, device=None) -> dict:
    """Float32 parameters with the reference's distributions: trunc-normal
    / sqrt(fan-in) projections, conv taps N(0, 0.1^2), S4D-real ``a_log``
    = log(1..d_state) on every channel, ``d_skip`` ones."""
    d_in = cfg.d_inner
    a = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                     device=device).repeat(d_in, 1)
    p = {"in_proj": init_dense(cfg.d_model, 2 * d_in, generator=generator,
                               bias=False, device=device),
         "conv_w": torch.randn(cfg.conv_kernel, d_in, generator=generator,
                               device=device) * 0.1,
         "conv_b": torch.zeros(d_in, device=device),
         "x_proj": init_dense(d_in, cfg.dtr + 2 * cfg.d_state,
                              generator=generator, bias=False, device=device),
         "dt_proj": init_dense(cfg.dtr, d_in, generator=generator, bias=True,
                               device=device),
         "a_log": torch.log(a),
         "d_skip": torch.ones(d_in, device=device),
         "out_proj": init_dense(d_in, cfg.d_model, generator=generator,
                                bias=False, device=device)}
    return p


def _causal_conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, x (B, T, C)."""
    k = p["conv_w"].shape[0]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + t, :] * p["conv_w"][i]
    return out + p["conv_b"]


def _ssm_inputs(p: dict, cfg: SSMConfig, xc: torch.Tensor):
    """Data-dependent dt, B, C from the conv output xc (B, T, d_inner)."""
    proj = dense(p["x_proj"], xc, name="x_proj")
    dt_low = proj[..., :cfg.dtr]
    b = proj[..., cfg.dtr:cfg.dtr + cfg.d_state]
    c = proj[..., cfg.dtr + cfg.d_state:]
    dt = F.softplus(dense(p["dt_proj"], dt_low, name="dt_proj"))
    return dt, b, c


def _decay_rate(p: dict) -> torch.Tensor:
    """A = -exp(a_log), (d_inner, d_state) float32."""
    return -torch.exp(p["a_log"].to(torch.float32))


def _scan(h: torch.Tensor, a: torch.Tensor, xc, dt, bmat, cmat):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = h_t . C_t, from
    ``h`` (B, d_inner, d_state) float32 over xc/dt (B, T, d_inner) and
    bmat/cmat (B, T, d_state).  Returns (y (B, T, d_inner) float32, the
    last h), with the reference step's dtypes: the input term is formed in
    the activations' dtype, the state and outputs in float32."""
    ys = []
    # time-major chunks, so that each step's operands are contiguous
    xc, dt, bmat, cmat = (v.transpose(0, 1) for v in (xc, dt, bmat, cmat))
    for lo in range(0, xc.shape[0], SCAN_CHUNK):
        sl = slice(lo, lo + SCAN_CHUNK)
        da = torch.exp(dt[sl, :, :, None] * a)  # (tc, B, d_in, ds)
        dbx = ((dt[sl] * xc[sl])[..., None]
               * bmat[sl, :, None, :]).to(torch.float32)
        hs = []
        for j in range(da.shape[0]):
            h = torch.addcmul(dbx[j], da[j], h)
            hs.append(h)
        ys.append(torch.einsum("tbds,tbs->btd", torch.stack(hs),
                               cmat[sl].to(torch.float32)))
    return torch.cat(ys, 1), h


def ssm_scan(p: dict, x: torch.Tensor, cfg: SSMConfig):
    """x (B, T, d_model) from a zero state -> (y (B, T, d_model), the final
    state {"conv": the last conv_kernel - 1 inputs (B, k-1, d_inner), "h":
    (B, d_inner, d_state) float32})."""
    b_, _, _ = x.shape
    xz = dense(p["in_proj"], x, name="in_proj")
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(p, xin))
    dt, bmat, cmat = _ssm_inputs(p, cfg, xc)
    h0 = torch.zeros((b_, cfg.d_inner, cfg.d_state), dtype=torch.float32,
                     device=x.device)
    ys, h = _scan(h0, _decay_rate(p), xc, dt, bmat, cmat)
    y = (ys.to(x.dtype) + xc * p["d_skip"]).to(x.dtype)
    y = y * F.silu(z)
    out = dense(p["out_proj"], y, name="out_proj").to(x.dtype)
    return out, {"conv": xin[:, -(cfg.conv_kernel - 1):, :], "h": h}


def ssm_prefill(p: dict, x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """x (B, T, d_model) -> (B, T, d_model); zero initial state."""
    return ssm_scan(p, x, cfg)[0]


def init_ssm_state(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device=None) -> dict:
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                             dtype=torch.float32, device=device)}


def ssm_decode_step(p: dict, x: torch.Tensor, state: dict, cfg: SSMConfig):
    """x (B, 1, d_model); O(1) state update.  Returns (out (B, 1, d_model),
    the new state {"conv", "h"}) and writes it INTO ``state``'s tensors."""
    xz = dense(p["in_proj"], x, name="in_proj")
    xin, z = torch.chunk(xz, 2, dim=-1)  # (B, 1, d_in)
    dt_buf = torch.promote_types(state["conv"].dtype, xin.dtype)
    conv_buf = torch.cat([state["conv"].to(dt_buf), xin.to(dt_buf)], dim=1)
    w = p["conv_w"]
    dt_c = torch.promote_types(dt_buf, w.dtype)
    xc = torch.einsum("bkd,kd->bd", conv_buf.to(dt_c), w.to(dt_c)) \
        + p["conv_b"]
    xc = F.silu(xc)[:, None, :]
    dt, bmat, cmat = _ssm_inputs(p, cfg, xc)
    a = _decay_rate(p)
    da = torch.exp(dt[:, 0, :, None] * a)
    dbx = (dt[:, 0] * xc[:, 0])[..., None] * bmat[:, 0][:, None, :]
    h = torch.addcmul(dbx.to(torch.float32), da, state["h"])
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0].to(torch.float32))
    y = y[:, None, :].to(x.dtype)
    y = (y + xc * p["d_skip"]).to(x.dtype)
    y = y * F.silu(z)
    out = dense(p["out_proj"], y, name="out_proj").to(x.dtype)
    state["conv"].copy_(conv_buf[:, 1:])
    state["h"].copy_(h)
    return out, state
