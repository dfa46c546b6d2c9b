"""A/B shadow serving: a second NumericsSpec pack mirrors live traffic
(port of ``repro.serving.shadow``).

A deterministic sample of FINISHED requests replays teacher-forced: both
packs forward the primary's emitted sequence in ``(slots,
prefill_chunk)``-shaped calls on a private contiguous slot cache, and the
runner diffs them where it matters:

  * **tokens** — would the shadow pack have emitted the same argmax token
    at each generation position (the speculative acceptance measure);
  * **logits** — elementwise logit-delta moments at the generation
    positions, Chan-merged across replays;
  * **power** — each pack's MAC-weighted modeled array-power saving
    (:func:`repro_torch.serving.engine.power_profile_from_params`).

:meth:`ShadowRunner.verdict` folds the three into an accuracy-vs-power
recommendation ("adopt-shadow" / "keep-primary", with the reason).

Teacher forcing along the PRIMARY's tokens keeps both packs on identical
inputs, so the diff isolates the numerics; a replay costs
``ceil(len / chunk)`` chunk-shaped calls a pack.  On the card every such
call of a ``backend: "pallas"`` pack runs the approx-matmul kernel's
prep + ``wgmma`` tile (``slots * chunk`` rows, above the split-K decode
rows).  The logit deltas are reduced on the logits' device in float64;
only the moments and the match count come to the host.
"""

from __future__ import annotations

import torch

from repro_torch.serving.kv_pool import SlotPool
from repro_torch.serving.metrics import _merge_moments

#: token agreement at or above this adopts the shadow pack (if it also
#: saves modeled power); below it the verdict is keep-primary on accuracy
MIN_TOKEN_MATCH = 0.9


class ShadowRunner:
    """Teacher-forced dual-pack replay + accuracy-vs-power verdict."""

    def __init__(self, api, ecfg, primary_params, shadow_params,
                 primary_label: str, shadow_label: str) -> None:
        if not 0 < ecfg.shadow_fraction <= 1:
            raise ValueError("shadow_fraction must be in (0, 1], got "
                             f"{ecfg.shadow_fraction}")
        if api.cfg.rwkv:
            raise NotImplementedError(
                f"{api.cfg.name}: shadow replay resets the slot cache by "
                "cursor; recurrent RWKV state has no cursor")
        self.api = api
        self.primary_params = primary_params
        self.shadow_params = shadow_params
        self.primary_label = primary_label
        self.shadow_label = shadow_label
        self.fraction = float(ecfg.shadow_fraction)
        #: deterministic sampling: every Nth finished request replays
        self.every = max(1, round(1.0 / self.fraction))
        self.chunk = ecfg.prefill_chunk
        self.slots = ecfg.slots
        # a private contiguous slot cache, whatever the engine's layout:
        # replays never touch the engine's pool, and the (slots, chunk)
        # call shape is one the engine already runs.  A replay starts by
        # zeroing the cursors; stale K/V past them is position-masked.
        self._pool = SlotPool(api, ecfg.slots, ecfg.max_len,
                              ecfg.cache_dtype)
        self.sampled = 0
        self.tokens = 0
        self.matches = 0
        self._logits: tuple[int, float, float] = (0, 0.0, 0.0)
        self._max_abs = 0.0
        self.primary_saving_pct = _pack_saving_pct(primary_params)
        self.shadow_saving_pct = _pack_saving_pct(shadow_params)

    # -- sampling ------------------------------------------------------------

    def wants(self, finish_index: int) -> bool:
        """Deterministic request sampling by finish order (1-based)."""
        return finish_index % self.every == 0

    # -- replay --------------------------------------------------------------

    def _forward(self, params, fed: list[int]) -> torch.Tensor:
        """Teacher-forced float32 logits ``(len(fed), vocab)`` of one token
        sequence, chunk by chunk: row 0 of each (slots, chunk) call carries
        the tokens, the other rows ride with ``n_valid = 0``."""
        cache = self._pool.cache
        cache["lengths"].zero_()
        dev = cache["lengths"].device
        outs = []
        for off in range(0, len(fed), self.chunk):
            part = fed[off:off + self.chunk]
            toks = torch.zeros(self.slots, self.chunk, dtype=torch.long)
            toks[0, :len(part)] = torch.as_tensor(part)
            nv = [len(part)] + [0] * (self.slots - 1)
            logits, _ = self.api.decode_slots(params, toks.to(dev), cache, nv)
            outs.append(logits[0, :len(part)].float())
        return torch.cat(outs, dim=0)

    def replay(self, prompt, generated) -> dict:
        """Replay one finished request through BOTH packs; returns the
        per-request record ``EngineMetrics.record_shadow`` consumes."""
        prompt = [int(t) for t in prompt]
        generated = [int(t) for t in generated]
        if not generated:
            raise ValueError("shadow replay needs generated tokens")
        plen = len(prompt)
        fed = prompt + generated[:-1]  # inputs; outputs predict fed[i+1]
        lg_p = self._forward(self.primary_params, fed)
        lg_s = self._forward(self.shadow_params, fed)
        # generation positions: fed index plen-1 predicts generated[0], ...
        gen_p, gen_s = lg_p[plen - 1:], lg_s[plen - 1:]
        want = torch.as_tensor(generated, device=gen_s.device)
        delta = (gen_s.double() - gen_p.double()).flatten()
        matches, mean, var, max_abs = torch.stack([
            (gen_s.argmax(dim=-1) == want).sum().double(), delta.mean(),
            delta.var(correction=0), delta.abs().max()]).tolist()
        rec = {
            "tokens": len(generated),
            "matches": int(matches),
            "logits_err": {"n": int(delta.numel()), "mean": mean,
                           "var": var, "max_abs": max_abs},
        }
        self.sampled += 1
        self.tokens += rec["tokens"]
        self.matches += rec["matches"]
        self._logits = _merge_moments(self._logits,
                                      (delta.numel(), mean, var))
        self._max_abs = max(self._max_abs, max_abs)
        return rec

    # -- verdict -------------------------------------------------------------

    def verdict(self) -> dict | None:
        """The accuracy-vs-power recommendation over everything sampled so
        far (None until a replay happened)."""
        if not self.sampled:
            return None
        match_rate = self.matches / self.tokens if self.tokens else 0.0
        _, _, err_var = self._logits
        power_delta = round(self.shadow_saving_pct
                            - self.primary_saving_pct, 2)
        if match_rate < MIN_TOKEN_MATCH:
            decision = "keep-primary"
            reason = (f"token match {match_rate:.3f} below "
                      f"{MIN_TOKEN_MATCH:g} threshold")
        elif power_delta > 0:
            decision = "adopt-shadow"
            reason = (f"token match {match_rate:.3f} >= "
                      f"{MIN_TOKEN_MATCH:g} and modeled power saving "
                      f"+{power_delta:g}pp")
        else:
            decision = "keep-primary"
            reason = (f"accuracy parity but no modeled power win "
                      f"({power_delta:+g}pp)")
        return {
            "primary": self.primary_label,
            "shadow": self.shadow_label,
            "sampled_requests": self.sampled,
            "sampled_fraction": round(1.0 / self.every, 4),
            "tokens": self.tokens,
            "token_matches": self.matches,
            "token_match_rate": round(match_rate, 4),
            "logits_err_var": err_var,
            "logits_err_max_abs": self._max_abs,
            "primary_power_saving_pct": round(self.primary_saving_pct, 2),
            "shadow_power_saving_pct": round(self.shadow_saving_pct, 2),
            "power_delta_pct": power_delta,
            "verdict": decision,
            "reason": reason,
        }


def _pack_saving_pct(params) -> float:
    """MAC-weighted modeled array-power saving of one pack."""
    from repro_torch.serving.engine import power_profile_from_params

    prof = power_profile_from_params(params)
    units = sum(e["mac_per_token"] for e in prof.values())
    saved = sum(e["mac_per_token"] * e["saving_pct"] / 100.0
                for e in prof.values())
    return 100.0 * saved / units if units else 0.0
