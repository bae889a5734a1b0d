"""Adam with low-precision moment storage (``sunet_tf_tpu/train/adam.py``).

Adam(b1, b2, eps) under a per-step learning rate, the moments STORED in a
chosen dtype while all arithmetic runs in float32:

- ``mu`` (decay 0.9) in bfloat16: its per-step increments are far above
  the bf16 ulp, so plain rounding is noise-level.
- ``nu`` (decay 0.999) in bfloat16 with STOCHASTIC rounding: its increments
  are below the bf16 ulp, so plain rounding would freeze it; a random
  dither added to the float32 bit pattern before truncation rounds up with
  probability equal to the discarded fraction, which keeps the EMA
  unbiased. One 16-bit dither per tensor per step, drawn from a generator
  seeded by (sr_seed, step), so runs and resumes are reproducible.

The update is torch.optim.Adam's arithmetic, op for op (lerp for mu,
mul/addcmul for nu, step size lr/bc1, denominator sqrt(nu)/sqrt(bc2) +
eps), so with float32 moments it equals torch.optim.Adam bit for bit.
``lr_schedule(step)`` gives the rate of the step-th update (0-based); the
trainer passes the reference schedule's closed form
(``train/schedule.py::lr_for_step``, the JAX ``make_optax_lr_schedule``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def stochastic_round_bf16(x: torch.Tensor, dither: int) -> torch.Tensor:
    """float32 ``x`` (non-negative, finite) -> bfloat16, rounding up with
    probability equal to the fraction of the ulp cut off; ``dither`` in
    [0, 2**16) is shared by the whole tensor."""
    bits = x.contiguous().view(torch.int32)
    kept = (bits + int(dither)) & -65536    # keep the top 16 bits
    return kept.view(torch.float32).to(torch.bfloat16)


class AdamLP:
    """Adam over ``params`` with moment storage dtypes ``mu_dtype`` and
    ``nu_dtype`` (float32 or bfloat16) and stochastic rounding of a
    bfloat16 nu when ``stochastic_round_nu``."""

    def __init__(self, params, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mu_dtype: str = "float32",
                 nu_dtype: str = "float32", stochastic_round_nu: bool = False,
                 sr_seed: int = 0):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype, self.nu_dtype = DTYPES[mu_dtype], DTYPES[nu_dtype]
        self.sr = stochastic_round_nu and self.nu_dtype == torch.bfloat16
        self.sr_seed = sr_seed
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=self.nu_dtype) for p in self.params]

    def lr(self) -> float:
        """The rate of the next update."""
        return float(self.lr_schedule(self.count))

    def _dither(self) -> Optional[list]:
        if not self.sr:
            return None
        g = torch.Generator().manual_seed(self.sr_seed * 1_000_003 + self.count + 1)
        return torch.randint(0, 1 << 16, (len(self.params),), generator=g).tolist()

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad`` (None counts as 0)."""
        lr = self.lr()
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2_sqrt = (1.0 - self.b2 ** self.count) ** 0.5
        dither = self._dither()
        for i, p in enumerate(self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g.float()
            m = self.mu[i] if self.mu_dtype == torch.float32 else self.mu[i].float()
            v = self.nu[i] if self.nu_dtype == torch.float32 else self.nu[i].float()
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt().div_(bc2_sqrt).add_(self.eps), value=-lr / bc1)
            if self.mu_dtype != torch.float32:
                self.mu[i] = m.to(self.mu_dtype)
            if self.nu_dtype != torch.float32:
                self.nu[i] = (stochastic_round_bf16(v, dither[i]) if self.sr
                              else v.to(self.nu_dtype))

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.mu = [m.to(device=p.device, dtype=self.mu_dtype)
                   for m, p in zip(state["mu"], self.params)]
        self.nu = [v.to(device=p.device, dtype=self.nu_dtype)
                   for v, p in zip(state["nu"], self.params)]
