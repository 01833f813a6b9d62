"""One HMC update of the phonon field, in plain PyTorch, and the energy of a
state.

The update as the upstream package defines it for ``[hmc]`` input files
(momentum_conservation_fraction 0): momenta v₀ = 𝓜^(−½)·R from unit normals
R, with 𝓜 the Fourier-acceleration mass (diagonal in the τ frequency);
pseudofermions φ = Λ⁻¹·Mᵀ·η per spin from unit normals η (Mᵀ·η for SSH);
H = ½·Σ_spins (Λφ)ᵀ·(MᵀM)⁻¹·(Λφ) + Sb(x) + ½·vᵀ·𝓜·v. Nt = T/dt leapfrog
steps, each a half kick by the fermion force, Nb bosonic sub-steps of
dt/Nb (a half kick by ∂Sb/∂x, a drift, a half kick), and a second half
kick by the fermion force at the new field; every kick is accelerated,
v ← v − h·𝓜⁻¹·F. The fermion force is ∂/∂x of ½·(Λφ)ᵀ(MᵀM)⁻¹(Λφ), taken
by autograd of zᵀ·Λ(x)φ − (Mz)ᵀ·M(x)·z with z = (MᵀM)⁻¹Λφ held fixed.
The update accepts with probability min(1, exp(−ΔH)) against a given
uniform draw.

The solves are conjugate gradients on MᵀM, unpreconditioned, to a relative
residual of ``tol`` (1e-7 by default; the program's trajectory solves run
to 1e-5), started from the linear extrapolation of the previous two
solutions; they stop early only when the residual has not fallen for
``STALL`` iterations (which happens only at a storage precision below
float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reference.models import Model

STALL = 60        # iterations without a new lowest residual that end a solve
CHECK_EVERY = 10  # iterations between the host's reads of the residuals


class Mass:
    """v ↦ F⁻¹·table^p·F·v along τ for the ``[Nph, Lτ]`` spectrum ``table``
    (FFT in float64, or float32 under a lower storage dtype)."""

    def __init__(self, table: np.ndarray, model: Model):
        self.model = model
        self.fdtype = torch.float64 if model.acc == torch.float64 else torch.float32
        self.table = torch.as_tensor(table, device=model.device, dtype=self.fdtype)

    def apply(self, v, power: float):
        f = torch.fft.fft(v.to(self.fdtype), dim=-1) * self.table ** power
        return torch.fft.ifft(f, dim=-1).real.to(self.model.dtype)


def dot(a, b, acc):
    """Per-system Σ a·b over the last two axes, accumulated in ``acc``."""
    return (a.to(acc) * b.to(acc)).sum(dim=(-2, -1))


def cg(apply_A, b, x0, tol: float, maxiter: int, acc):
    """Batched CG for A·x = b over the leading axes (one system per
    ``[..., N, Lτ]`` slice); converged systems stop moving. The host reads
    the residuals every ``CHECK_EVERY`` iterations. Returns (x, iterations
    of the slowest system)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - apply_A(x)
    p = r.clone()
    rr = dot(r, r, acc)
    goal = tol * tol * dot(b, b, acc).clamp_min(1e-300)
    best, best_x, since, it = rr.clone(), x.clone(), 0, 0
    while it < maxiter:
        if it % CHECK_EVERY == 0:
            if bool((rr <= goal).all()):
                break
            improved = rr < best
            if it and not bool(improved.any()):
                since += CHECK_EVERY
                if since >= STALL:
                    return best_x, it
            else:
                since = 0
            best = torch.where(improved, rr, best)
            best_x = torch.where(improved[..., None, None], x, best_x)
        Ap = apply_A(p)
        pAp = dot(p, Ap, acc)
        active = rr > goal
        alpha = torch.where(active, rr / torch.where(pAp != 0, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(rr))
        a = alpha.to(b.dtype)[..., None, None]
        x = x + a * p
        r = r - a * Ap
        rr_new = dot(r, r, acc)
        beta = torch.where(active, rr_new / rr.clamp_min(1e-300), torch.zeros_like(rr))
        p = r + beta.to(b.dtype)[..., None, None] * p
        rr = rr_new
        it += 1
    return x, it


@dataclass
class Update:
    """The reference's update of a batch of chains (float64 unless asked)."""

    x: torch.Tensor        # [C, Nph, Lτ] the trajectory's end (the proposal)
    v: torch.Tensor        # its momenta
    v0: torch.Tensor       # the refreshed momenta
    H0: torch.Tensor       # [C]
    H1: torch.Tensor
    dH: torch.Tensor
    accept: torch.Tensor   # [C] bool
    P: torch.Tensor        # [C] min(1, exp(−ΔH))


class HMC:
    """The update of ``model`` under the ``[hmc]`` table ``h`` and the
    ``[[fourier_acceleration]]`` blocks."""

    def __init__(self, model: Model, h: dict, fa_blocks, tol: float = 1e-7,
                 maxiter: int = 20000):
        if h.get("momentum_conservation_fraction", 0.0):
            raise ValueError("partial momentum refresh is not held by the reference")
        if str(h.get("integrator", "leapfrog")).lower() != "leapfrog":
            raise ValueError("the reference integrates by leapfrog")
        self.model = model
        self.dt = float(h["dt"])
        self.Nt = max(1, round(float(h["trajectory_time"]) / self.dt))
        self.Nb = int(h.get("num_multitimesteps", 1))
        self.mass = Mass(model.mass_table(fa_blocks), model)
        self.tol, self.maxiter = tol, maxiter
        self.iterations = 0

    # --- pieces -------------------------------------------------------------

    def solve(self, x, Lphi, guess=None):
        der = self.model.derived(x)
        z, it = cg(lambda v: self.model.mulMTM(der, v), Lphi, guess, self.tol, self.maxiter,
                   self.model.acc)
        self.iterations += it
        return z

    def force(self, x, phi, z):
        """∂/∂x of ½·(Λφ)ᵀ(MᵀM)⁻¹(Λφ) at x, z = (MᵀM)⁻¹Λφ."""
        m = self.model
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            der = m.derived(xg)
            zd = z.detach()
            Mz = m.mulM(m.derived(x.detach()), zd).detach()
            g = (zd * m.lam_phi(xg, phi)).sum() - (Mz * m.mulM(der, zd)).sum()
            (F,) = torch.autograd.grad(g, xg)
        return F.to(m.dtype)

    def kinetic(self, v):
        return dot(v, self.mass.apply(v, 1.0), self.model.acc) / 2

    def action(self, x, Lphi, z):
        return dot(Lphi, z, self.model.acc).sum(dim=1) / 2 + self.model.Sb(x)

    def energy(self, x, v, phi):
        """H at (x, v) for the pseudofermions φ (a fresh solve from zero)."""
        Lphi = self.model.lam_phi(x, phi)
        z = self.solve(x, Lphi)
        return self.action(x, Lphi, z) + self.kinetic(v)

    def refresh(self, x0, momentum, eta):
        """(v₀, φ) of the draws."""
        m = self.model
        v0 = self.mass.apply(momentum.to(m.dtype), -0.5)
        return v0, m.phi_from(x0, eta.to(m.dtype))

    # --- the update ---------------------------------------------------------

    def update(self, x0, momentum, eta, uniform) -> Update:
        m = self.model
        x0 = x0.to(m.dtype)
        v0, phi = self.refresh(x0, momentum, eta)
        Lphi = m.lam_phi(x0, phi)
        z = self.solve(x0, Lphi)
        H0 = self.action(x0, Lphi, z) + self.kinetic(v0)
        Qf = self.mass.apply(self.force(x0, phi, z), -1.0)
        x, v, h = x0, v0, self.dt / self.Nb
        z_prev = z
        for _ in range(self.Nt):
            v = v - self.dt / 2 * Qf
            for _ in range(self.Nb):
                v = v - h / 2 * self.mass.apply(m.dSb(x), -1.0)
                x = x + h * v
                v = v - h / 2 * self.mass.apply(m.dSb(x), -1.0)
            z, z_prev = self.solve(x, m.lam_phi(x, phi), guess=2 * z - z_prev), z
            Qf = self.mass.apply(self.force(x, phi, z), -1.0)
            v = v - self.dt / 2 * Qf
        Lphi = m.lam_phi(x, phi)
        z = self.solve(x, Lphi, guess=z)
        H1 = self.action(x, Lphi, z) + self.kinetic(v)
        dH = H1 - H0
        P = torch.clamp(torch.exp(-dH.double()), max=1.0)
        accept = uniform.to(P.device).double() < P
        return Update(x=x, v=v, v0=v0, H0=H0, H1=H1, dH=dH, accept=accept, P=P)

