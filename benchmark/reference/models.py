"""The fermion matrix, the Λ shift and the phonon action of the Holstein and
optical SSH models, in plain PyTorch.

For a phonon field x ``[C, Nph, Lτ]`` and fermion fields ``[C, S, N, Lτ]``
(S spins or probes), with ε(0) = −1 and ε(τ > 0) = +1:

    (M·v)(τ)  = v(τ) − ε(τ)·B(τ)·v(τ−1)
    (Mᵀ·u)(τ) = u(τ) − ε(τ+1)·B(τ+1)ᵀ·u(τ+1)        (indices mod Lτ)

* Holstein: B(τ) = exp(−Δτ·K)·exp(−Δτ·V(τ)), V(τ)ᵢᵢ = λᵢxᵢ(τ) − μᵢ;
* SSH: B(τ) = exp(−Δτ·K[x(τ)])·exp(+Δτ·μ), the hopping of bond b at slice τ
  t′ = t − α·x_b(τ).

exp(−Δτ·K) is the checkerboard product of :mod:`.lattice`: group g
rotates each of its bonds (i, j) by [c s; s c] with c = cosh(Δτ·t),
s = sinh(Δτ·t); its transpose applies the groups in reverse order.

Holstein's exponential shift: Λ(i, τ) = exp(−Δτ·λᵢxᵢ(τ)/2) and the
operators (Λ·v)(τ) = −ε(τ+1)·Λ(τ+1)·v(τ+1), (Λ⁻¹·v)(τ) = −ε(τ)·v(τ−1)/Λ(τ).

Phonon action Sb = Σ Δτ·(ω²x²/2 + ω₄x⁴) + (x(τ) − x(τ−1))²/(2Δτ).

Every operation here is an ordinary torch call on tensors of one storage
dtype (float64 for the reference, bfloat16 for its lower-precision
control); sums accumulate in ``acc`` (float64, or float32 under bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.lattice import Bonds, square_bonds


def _eps(Lt: int, like):
    """ε(τ) as a ``[Lτ]`` tensor: −1 at τ = 0, else +1."""
    e = torch.ones(Lt, dtype=like.dtype, device=like.device)
    e[0] = -1.0
    return e


class Model:
    """One of the two models, built from the parsed input file ``cfg``."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.acc = torch.float32 if dtype in (torch.bfloat16, torch.float16) else torch.float64
        lat = cfg["lattice"]
        if lat["ndim"] != 2 or lat["norbits"] != 1:
            raise ValueError("the reference holds square lattices with one orbital")
        self.L = int(lat["L"])
        self.N = self.L * self.L
        self.holstein = "holstein" in cfg
        m = cfg["holstein" if self.holstein else "ssh"]
        self.dtau = float(m["dtau"])
        self.Lt = int(round(float(m["beta"]) / self.dtau))
        (self._holstein if self.holstein else self._ssh)(m)
        self.groups = self._group_tables()

    # --- construction -------------------------------------------------

    def _holstein(self, m: dict) -> None:
        def one(key, default=None):
            rows = m.get(key, [])
            if not rows:
                if default is None:
                    raise ValueError(f"[holstein] needs {key}")
                return default
            if len(rows) != 1 or rows[0].get("stddev", 0.0) or rows[0]["orbit"] != [1]:
                raise ValueError(f"[holstein] {key}: the reference holds one uniform value")
            return float(rows[0]["val"])

        for key in ("lambda2", "omega_ij"):
            if m.get(key):
                raise ValueError(f"[holstein] {key} is not held by the reference")
        self.omega = one("omega")
        self.lam = one("lambda")
        self.mu = one("mu", 0.0)
        self.omega4 = one("omega4", 0.0)
        rules, t = [], []
        for d in m["t"]:
            if d.get("stddev", 0.0) or d.get("imag", 0.0) or d["orbit"] != [1, 1]:
                raise ValueError("[holstein] t: the reference holds uniform real hopping")
            rules.append((0, 0, tuple(d["dL"])))
            t.append(float(d["val"]))
        self.bonds: Bonds = square_bonds(self.L, rules)
        self.t_bond = np.asarray(t)[self.bonds.definition]
        self.Nph = self.N
        self.omega_ph = np.full(self.N, self.omega)

    def _ssh(self, m: dict) -> None:
        rules, t, alpha, omega, omega4, names = [], [], [], [], [], []
        for d in m["hopping"]:
            for key in ("t_std", "alpha_std", "omega_std", "alpha2_avg", "omega4_std"):
                if d.get(key, 0.0):
                    raise ValueError(f"[ssh] hopping {key} is not held by the reference")
            if d["orbits"] != [1, 1] or d.get("omega_avg", 0.0) == 0.0:
                raise ValueError("[ssh] the reference holds one orbital, a phonon on every bond")
            rules.append((0, 0, tuple(d["dL"])))
            t.append(float(d.get("t_avg", 0.0)))
            alpha.append(float(d.get("alpha_avg", 0.0)))
            omega.append(float(d["omega_avg"]))
            omega4.append(float(d.get("omega4_avg", 0.0)))
            names.append(d.get("name", ""))
        if len(set(names)) != len(names):
            raise ValueError("[ssh] aliased phonons (repeated names) are not held by the reference")
        mus = m.get("mu", [])
        if len(mus) > 1 or (mus and (mus[0].get("stddev", 0.0) or mus[0]["orbit"] != [1])):
            raise ValueError("[ssh] mu: the reference holds one uniform value")
        self.mu = float(mus[0]["val"]) if mus else 0.0
        self.bonds = square_bonds(self.L, rules)
        de = self.bonds.definition
        self.t_bond = np.asarray(t)[de]
        self.alpha_ph = np.asarray(alpha)[de]       # one phonon per bond, bond order
        self.omega_ph = np.asarray(omega)[de]
        self.omega4_ph = np.asarray(omega4)[de]
        self.Nph = de.size

    def _group_tables(self):
        """Per group: partner ``[N]``, the bond of each site ``[N]`` and the
        sites the group touches ``[N]`` (bool), on the device."""
        out = []
        for g in self.bonds.groups:
            partner = np.arange(self.N)
            bond = np.zeros(self.N, dtype=np.int64)
            touched = np.zeros(self.N, dtype=bool)
            for b in g:
                i, j = self.bonds.pairs[:, b]
                partner[i], partner[j] = j, i
                bond[i] = bond[j] = b
                touched[i] = touched[j] = True
            out.append(tuple(torch.as_tensor(a, device=self.device)
                             for a in (partner, bond, touched)))
        return out

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)

    # --- exp(−Δτ·K) ----------------------------------------------------

    def hopping(self, x):
        """(cosh, sinh) of Δτ·t per bond: ``[Nb]`` for Holstein, ``[C, Nb, Lτ]``
        for SSH at the field x."""
        t = self.tensor(self.t_bond)
        if self.holstein:
            arg = self.dtau * t
        else:
            arg = self.dtau * (t[:, None] - self.tensor(self.alpha_ph)[:, None] * x)
        return torch.cosh(arg), torch.sinh(arg)

    def coeffs(self, hop):
        """Per group: (partner, c, s), c and s gathered onto the sites
        (1 and 0 where the group touches no bond), shaped against
        ``[C, S, N, Lτ]`` fields."""
        c_b, s_b = hop
        out = []
        for partner, bond, touched in self.groups:
            if c_b.ndim == 1:
                c = torch.where(touched, c_b[bond], torch.ones_like(c_b[bond]))[:, None]
                s = torch.where(touched, s_b[bond], torch.zeros_like(s_b[bond]))[:, None]
            else:
                t3 = touched[None, :, None]
                c = torch.where(t3, c_b[:, bond], torch.ones_like(c_b[:, bond]))[:, None]
                s = torch.where(t3, s_b[:, bond], torch.zeros_like(s_b[:, bond]))[:, None]
            out.append((partner, c, s))
        return out

    def fold(self, coeffs, v, transpose: bool = False):
        """exp(−Δτ·K)·v (or its transpose) over the site axis of v
        ``[C, S, N, Lτ]``; SSH's tables act column by column."""
        for partner, c, s in (reversed(coeffs) if transpose else coeffs):
            v = torch.addcmul(c * v, s, v.index_select(-2, partner))
        return v

    # --- M, Mᵀ ----------------------------------------------------------

    def derived(self, x):
        """What B(τ) needs at the field x: Holstein's diagonal
        exp(−Δτ·V) ``[C, 1, N, Lτ]`` with its hopping tables, SSH's tables."""
        if self.holstein:
            d = torch.exp(-self.dtau * (self.lam * x - self.mu))[:, None]
            return d, self.coeffs(self.hopping(x))
        return torch.exp(torch.full((), self.dtau * self.mu, dtype=self.dtype,
                                    device=self.device)), self.coeffs(self.hopping(x))

    def apply_B(self, der, v):
        """B(τ)·v(τ) for every τ (v already shifted)."""
        diag, co = der
        return self.fold(co, diag * v)

    def apply_BT(self, der, u):
        diag, co = der
        return diag * self.fold(co, u, transpose=True)

    def mulM(self, der, v):
        eps = _eps(self.Lt, v)
        return v - eps * self.apply_B(der, torch.roll(v, 1, dims=-1))

    def mulMT(self, der, u):
        # roll(w, −1)(τ) = w(τ+1), so ε is taken at τ+1 before the roll
        return u - torch.roll(_eps(self.Lt, u) * self.apply_BT(der, u), -1, dims=-1)

    def mulMTM(self, der, v):
        return self.mulMT(der, self.mulM(der, v))

    # --- Λ (Holstein) -----------------------------------------------------

    def Lam(self, x):
        return torch.exp(-self.dtau * self.lam * x / 2)[:, None]

    def mulLambda(self, Lam, v):
        w = Lam * v
        return -torch.roll(_eps(self.Lt, v) * w, -1, dims=-1)

    def mulLambdaInv(self, Lam, v):
        return -_eps(self.Lt, v) * torch.roll(v, 1, dims=-1) / Lam

    def lam_phi(self, x, phi):
        """Λ(x)·φ (φ itself for SSH)."""
        return self.mulLambda(self.Lam(x), phi) if self.holstein else phi

    def phi_from(self, x, R):
        """φ = Λ⁻¹·Mᵀ·R at x (Mᵀ·R for SSH)."""
        MtR = self.mulMT(self.derived(x), R)
        return self.mulLambdaInv(self.Lam(x), MtR) if self.holstein else MtR

    # --- phonon action -----------------------------------------------------

    def Sb(self, x):
        om = self.tensor(self.omega_ph)[:, None]
        om4 = (self.omega4 if self.holstein else self.tensor(self.omega4_ph)[:, None])
        dx = x - torch.roll(x, 1, dims=-1)
        sb = self.dtau * (om * om * x * x / 2 + om4 * x ** 4) + dx * dx / (2 * self.dtau)
        return sb.to(self.acc).sum(dim=(-2, -1))

    def dSb(self, x):
        """∂Sb/∂x, by autograd."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.Sb(xg).sum(), xg)
        return g.to(self.dtype)

    # --- Fourier acceleration ------------------------------------------------

    def mass_table(self, blocks) -> np.ndarray:
        """The dynamical-mass spectrum ``[Nph, Lτ]`` of the
        ``[[fourier_acceleration]]`` blocks (mass m on phonons with
        ω_min < ω < ω_max, 1 elsewhere): Δτ·(m² + ω² + (2 − 2cos(2πk/Lτ))/Δτ²)
        / (m² + ω²), k folded to min(k, Lτ − k)."""
        om = np.asarray(self.omega_ph, dtype=np.float64)
        k = np.arange(self.Lt)
        kp = np.minimum(k, self.Lt - k)
        lap = (2.0 - 2.0 * np.cos(2 * np.pi * kp / self.Lt)) / self.dtau ** 2
        table = np.ones((om.size, self.Lt))
        for blk in blocks:
            if blk.get("c", 0.0):
                raise ValueError("a mass block with c is not held by the reference")
            m = float(blk["mass"])
            sel = (om > blk["omega_min"]) & (om < blk["omega_max"])
            o2 = (om[sel] ** 2)[:, None]
            table[sel] = self.dtau * (m * m + o2 + lap[None, :]) / (m * m + o2)
        return table
