"""Adaptive chemical-potential tuning toward a target density.

Counterpart of ``elphdynamics_tpu/measure/mufinder.py`` (numpy only, the
same arithmetic). After each measurement, ⟨N̂⟩ and ⟨N̂²⟩ estimates feed
forgetful running statistics (the most recent ``c`` fraction of the
history); the compressibility κ̄ = β·var(N) is clamped to
[κ_min/√n, √var(N)/σ_μ] and the next chemical potential is

    μ ← μ̄ + (N_target − N̄)/κ̄

Host-side bookkeeping: the driver reads the scalar ⟨N⟩/⟨N²⟩ of each
measurement and shifts the parameters' μ by the returned value.
"""

from __future__ import annotations

import numpy as np


class MuTuner:
    def __init__(self, active: bool, init_mu: float, target_N: float, N: int,
                 beta: float, dtau: float, forgetful_c: float, kappa_min: float,
                 logfile: str | None = None):
        self.active = active
        self.mu = float(init_mu)
        self.target_N = float(target_N)
        self.N = int(N)
        self.beta = float(beta)
        self.dtau = float(dtau)
        self.forgetful_c = float(forgetful_c)
        self.kappa_min = float(kappa_min)
        self.mu_traj = [float(init_mu)]
        self.N_traj: list[float] = []
        self.N2_traj: list[float] = []
        self.mu_bar = float(init_mu)
        self.mu_std = 0.0
        self.N_bar = -1.0
        self.N2_bar = -1.0
        self.kappa_bar = float(kappa_min)
        self.mu_avg = float(init_mu)
        self.mu_err = 0.0
        self.logfile = logfile
        if logfile and active:
            with open(logfile, "w") as f:
                f.write("mu_bar kappa_bar n_bar Nsqr_bar mu n Nsqr\n")

    # -- forgetful statistics (:212-262) ------------------------------------

    def _window(self, n):
        return 1 + int(np.floor((1.0 - self.forgetful_c) * n))

    def _forgetful_mean(self, traj):
        i = self._window(len(traj)) - 1
        return float(np.mean(traj[i:]))

    def _forgetful_std(self, traj):
        i = self._window(len(traj)) - 1
        window = traj[i:]
        return float(np.std(window, ddof=1)) if len(window) > 1 else 0.0

    # -- the update (:117-169) ---------------------------------------------

    def update(self, N_meas: float, N2_meas: float) -> float:
        """Record a new (⟨N⟩, ⟨N²⟩) measurement; return the updated μ."""
        self.N_traj.append(float(N_meas))
        self.N2_traj.append(float(N2_meas))
        self.mu_bar = self._forgetful_mean(self.mu_traj)
        self.mu_std = self._forgetful_std(self.mu_traj)
        self.N_bar = self._forgetful_mean(self.N_traj)
        self.N2_bar = self._forgetful_mean(self.N2_traj)

        n = len(self.N_traj)
        varN = self.N2_bar - self.N_bar ** 2
        kappa_lo = self.kappa_min / np.sqrt(n)
        if n == 1 or varN < 0.0 or self.mu_std <= 0.0:
            kappa_hi = kappa_lo
        else:
            kappa_hi = np.sqrt(varN) / self.mu_std
        kappa = self.beta * varN
        self.kappa_bar = float(np.clip(kappa, kappa_lo, max(kappa_hi, kappa_lo)))

        if self.logfile and self.active:
            with open(self.logfile, "a") as f:
                f.write(f"{self.mu_bar:.8f} {self.kappa_bar / self.N:.8f} "
                        f"{self.N_bar / self.N:.8f} {self.N2_bar:.8f} {self.mu:.8f} "
                        f"{N_meas / self.N:.8f} {N2_meas:.8f}\n")

        self.mu = self.mu_bar + (self.target_N - self.N_bar) / self.kappa_bar
        self.mu_traj.append(self.mu)
        return self.mu

    def estimate_mu(self):
        """Final best guess (μ, err) from the trajectory (:175-203)."""
        if not self.active:
            self.mu_avg = self.mu
            self.mu_err = 0.0
            return self.mu, 0.0
        c = self.forgetful_c if self.forgetful_c != 1.0 else 0.5
        idx = int(np.ceil(c * len(self.mu_traj))) - 1
        window = np.asarray(self.mu_traj[max(idx, 0):])
        self.mu_err = float(np.std(window - np.median(window), ddof=1)) if len(window) > 1 else 0.0
        self.mu_avg = self.mu_bar
        return self.mu_avg, self.mu_err

    # -- checkpoint support --------------------------------------------------

    def state_dict(self):
        return {
            "active": self.active, "mu": self.mu, "target_N": self.target_N,
            "mu_traj": list(self.mu_traj), "N_traj": list(self.N_traj),
            "N2_traj": list(self.N2_traj), "mu_bar": self.mu_bar,
            "mu_std": self.mu_std, "N_bar": self.N_bar, "N2_bar": self.N2_bar,
            "kappa_bar": self.kappa_bar,
        }

    def load_state_dict(self, st):
        for k, v in st.items():
            setattr(self, k, v)
