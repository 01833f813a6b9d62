"""Datafolder output: per-bin measurement files, key files, snapshots,
phonon configurations and the dense M matrix.

Counterpart of ``elphdynamics_tpu/io/output.py``, writing the same files in
the same layout and number format (one folder per measurement with per-bin
text files and ``*_key.out`` index files), so the analysis scripts that read
the JAX package's output read the port's. The writers take host (numpy)
arrays; the driver moves each bin off the device once.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from elphdynamics_tpu_torch.measure.measurements import SUSC_MAP, _corr_pairs, _normalize_kinds
from elphdynamics_tpu_torch.models.adapter import ModelOps


def init_measurement_folders(datafolder: str, container: dict, snapshots=()):
    """Create the per-measurement folder tree (Measurements.jl:343-540)."""
    os.makedirs(datafolder, exist_ok=True)
    for name in ("global_measurements_f", "onsite_measurements_f",
                 "intersite_measurements_f"):
        os.makedirs(os.path.join(datafolder, name), exist_ok=True)
    for group in ("onsite_corr", "intersite_corr"):
        for kind in container[group]:
            for space in ("position", "momentum"):
                os.makedirs(os.path.join(datafolder, f"{kind}_{space}_f"), exist_ok=True)
    for group in ("onsite_corr", "intersite_corr"):
        for kind in container[group]:
            if kind in SUSC_MAP and container[group][kind].shape[-1] > 1:
                for space in ("position", "momentum"):
                    os.makedirs(os.path.join(datafolder, f"{SUSC_MAP[kind]}_{space}_f"),
                                exist_ok=True)
    for snap in snapshots:
        os.makedirs(os.path.join(datafolder, f"{snap}_snapshots_f"), exist_ok=True)


def _flatten_reference_order(arr: np.ndarray) -> np.ndarray:
    """[p, L1, L2, L3, T] -> flat with T fastest, then L1, L2, L3, p —
    the reference's column-major (T,L1,L2,L3,p) iteration order
    (Measurements.jl:1266-1271)."""
    return np.transpose(arr, (0, 3, 2, 1, 4)).reshape(-1)


def write_bin(datafolder: str, processed: dict, bin_index: int, model_ops: ModelOps):
    """Write one bin of processed measurements (Measurements.jl:681-693)."""
    b = bin_index
    path = os.path.join(datafolder, "global_measurements_f",
                        f"global_measurements_{b:05d}.out")
    with open(path, "w") as f:
        for k, v in processed["global"].items():
            f.write(f"{k} {float(np.real(v)):.8f}\n")

    path = os.path.join(datafolder, "onsite_measurements_f",
                        f"onsite_measurements_{b:05d}.out")
    with open(path, "w") as f:
        f.write("measurement orbit value\n")
        for k, v in processed["onsite"].items():
            for o, val in enumerate(np.asarray(v)):
                f.write(f"{k} {o + 1} {float(np.real(val)):.8f}\n")

    path = os.path.join(datafolder, "intersite_measurements_f",
                        f"intersite_measurements_{b:05d}.out")
    with open(path, "w") as f:
        f.write("measurement bond value\n")
        for k, v in processed["intersite"].items():
            for o, val in enumerate(np.asarray(v)):
                f.write(f"{k} {o + 1} {float(np.real(val)):.8f}\n")

    for group in ("onsite_corr", "intersite_corr", "onsite_susc", "intersite_susc"):
        for kind, spaces in processed.get(group, {}).items():
            for space, arr in spaces.items():
                name = f"{kind}_{space}"
                path = os.path.join(datafolder, f"{name}_f", f"{name}_{b:05d}.out")
                a = np.asarray(arr)
                if a.ndim == 4:  # susceptibility: [p, L1, L2, L3]
                    flat = np.transpose(a, (0, 3, 2, 1)).reshape(-1)
                else:
                    flat = _flatten_reference_order(a)
                with open(path, "w") as f:
                    f.write(f"index {name}_real {name}_imag\n")
                    for i, val in enumerate(flat):
                        f.write(f"{i + 1} {val.real:.8f} {val.imag:.8f}\n")


def write_key_files(datafolder: str, ops: ModelOps, mspec, container: dict):
    """``*_key.out`` index files mapping every flattened row of the per-bin
    correlation/susceptibility files to its (pair, r/k displacement[, τ])
    labels. Row order matches :func:`_flatten_reference_order` (τ fastest,
    then r1, r2, r3, pair)."""
    lat = ops.spec.lattice
    no = lat.unit_cell.norbits
    ndefs = len(ops.spec.bond_defs)

    def rows(f, pairs, dims, lbl, with_tau, T=1):
        L1, L2, L3 = dims
        tau_col = " tau" if with_tau else ""
        i = 1
        for p in range(pairs.shape[0]):
            o1, o2 = int(pairs[p, 0]) + 1, int(pairs[p, 1]) + 1
            for l3 in range(L3):
                for l2 in range(L2):
                    for l1 in range(L1):
                        for tau in range(T):
                            tcol = f" {tau}" if with_tau else ""
                            f.write(f"{i} {o1} {o2} {l3} {l2} {l1}{tcol}\n")
                            i += 1

    for group, nbase, label, entries, default_pairs in (
        ("onsite_corr", no, "orbit", mspec.onsite_corr, mspec.onsite_pairs),
        ("intersite_corr", ndefs, "bond", mspec.intersite_corr,
         mspec.intersite_pairs),
    ):
        for kind, (td, kp) in _normalize_kinds(entries).items():
            pairs = _corr_pairs(nbase, kp if kp is not None else default_pairs)
            _, L1, L2, L3, T = container[group][kind].shape
            for space, lbl in (("position", "r"), ("momentum", "k")):
                folder = os.path.join(datafolder, f"{kind}_{space}_f")
                if not os.path.isdir(folder):
                    continue
                with open(os.path.join(folder, f"{kind}_{space}_key.out"), "w") as f:
                    f.write(f"index {label}1 {label}2 {lbl}3 {lbl}2 {lbl}1 tau\n")
                    rows(f, pairs, (L1, L2, L3), lbl, True, T)
            if kind in SUSC_MAP and T > 1:
                sname = SUSC_MAP[kind]
                for space, lbl in (("position", "r"), ("momentum", "k")):
                    folder = os.path.join(datafolder, f"{sname}_{space}_f")
                    if not os.path.isdir(folder):
                        continue
                    with open(os.path.join(folder,
                                           f"{sname}_{space}_key.out"), "w") as f:
                        f.write(f"index {label}1 {label}2 {lbl}3 {lbl}2 {lbl}1\n")
                        rows(f, pairs, (L1, L2, L3), lbl, False)


def write_snapshot(datafolder: str, name: str, values: np.ndarray, nmeas: int):
    """Per-measurement snapshot dump (Measurements.jl:1349-1460)."""
    path = os.path.join(datafolder, f"{name}_snapshots_f",
                        f"{name}_snapshot_{nmeas:06d}.out")
    with open(path, "w") as f:
        f.write(f"{name}\n")
        for v in np.asarray(values).reshape(-1):
            f.write(f"{float(v):.8f}\n")


# ---------------------------------------------------------------------------
# phonon-field text IO
# ---------------------------------------------------------------------------

def _phonon_types(ops: ModelOps) -> tuple[int, int]:
    """SSH: (phonon types, phonons per type)."""
    ntypes = max(len([d for d in ops.spec.bond_defs if d[3]]), 1)
    return ntypes, (ops.Nph // ntypes if ops.Nph else 0)


def write_phonons(ops: ModelOps, x, filename: str):
    """One chain's ``[Nph, Lτ]`` field. Holstein format: 'L3 L2 L1 orbit tau
    x'; SSH format: 'type loc tau x'."""
    x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    with open(filename, "w") as f:
        if not ops.is_holstein:
            ntypes, per_type = _phonon_types(ops)
            f.write("type loc tau x\n")
            for ptype in range(ntypes):
                for i in range(per_type):
                    ph = ptype * per_type + i
                    for tau in range(ops.Ltau):
                        f.write(f"{ptype + 1} {i + 1} {tau + 1} {x[ph, tau]:.6f}\n")
            return
        lat = ops.spec.lattice
        no = lat.unit_cell.norbits
        f.write("L3 L2 L1 orbit tau x\n")
        for l3 in range(lat.L3):
            for l2 in range(lat.L2):
                for l1 in range(lat.L1):
                    for orbit in range(no):
                        site = lat.loc_to_site(orbit, l1, l2, l3)
                        for tau in range(ops.Ltau):
                            f.write(f"{l3} {l2} {l1} {orbit + 1} {tau + 1} "
                                    f"{x[site, tau]:.6f}\n")


def read_phonons(ops: ModelOps, filename: str) -> np.ndarray:
    """Inverse of :func:`write_phonons`: a ``[Nph, Lτ]`` numpy field."""
    x = np.zeros((ops.Nph, ops.Ltau))
    with open(filename) as f:
        f.readline()
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if ops.is_holstein:
                l3, l2, l1, orbit, tau = (int(p) for p in parts[:5])
                site = ops.spec.lattice.loc_to_site(orbit - 1, l1, l2, l3)
                x[site, tau - 1] = float(parts[5])
            else:
                ptype, loc, tau = (int(p) for p in parts[:3])
                x[(ptype - 1) * _phonon_types(ops)[1] + (loc - 1), tau - 1] = float(parts[3])
    return x


def write_K_matrix(ops: ModelOps, params, x, filename: str, tau: int = 0):
    """The SSH hopping matrix K[τ] of one chain's ``[Nph, Lτ]`` field,
    on-site energies included: 'col row val' rows, or 'col row real imag'
    under twisted boundaries (K is Hermitian: the reversed entry is the
    conjugate)."""
    from elphdynamics_tpu_torch.models import ssh as Sm

    spec = ops.spec
    cplx = params.t_phase is not None
    x = torch.as_tensor(x, device=params.mu.device, dtype=params.mu.dtype)
    with open(filename, "w") as f:
        f.write("col row real imag\n" if cplx else "col row val\n")
        mu = params.mu.detach().cpu().numpy()
        for i in range(spec.Nsites):
            f.write(f"{i + 1} {i + 1} {-mu[i]} 0.0\n" if cplx else f"{i + 1} {i + 1} {-mu[i]}\n")
        tp = Sm.hopping_t_prime(spec, params, x)
        if cplx:
            tp = params.t_phase[:, None] * tp
        tp = tp.detach().cpu().numpy()
        for b in range(spec.Nbonds):
            s1, s2 = spec.ckb.neighbor_table[:, spec.bond_to_ckb[b]]
            val = -tp[b, tau]
            if cplx:
                f.write(f"{s1 + 1} {s2 + 1} {val.real} {val.imag}\n")
                f.write(f"{s2 + 1} {s1 + 1} {val.real} {-val.imag}\n")
            else:
                f.write(f"{s1 + 1} {s2 + 1} {val}\n")
                f.write(f"{s2 + 1} {s1 + 1} {val}\n")


def write_M_matrix(ops: ModelOps, params, x, filename: str, threshold=1e-10,
                   chunk: int = 512):
    """Densify M for one chain's field ``x`` ``[N, Lτ]`` column by column, in
    batches of ``chunk`` unit vectors, and write its nonzeros."""
    derived = ops.stack(ops.derived(params, x[None]))   # one chain
    N, L = ops.Nsites, ops.Ltau
    NL = N * L
    chunk = min(chunk, NL)
    rows = torch.arange(chunk, device=x.device)
    with open(filename, "w") as f:
        f.write("col row real imag\n")
        for start in range(0, NL, chunk):
            # pad the final batch by repeating the last column; extras skipped
            idx = torch.clamp(torch.arange(start, start + chunk, device=x.device), max=NL - 1)
            eye = torch.zeros((chunk, NL), dtype=x.dtype, device=x.device)
            eye[rows, idx] = 1.0
            cols = ops.mulM(params, derived, eye.reshape(1, chunk, N, L)).reshape(chunk, NL)
            cols = cols.cpu().numpy()
            for j in range(min(chunk, NL - start)):
                colv = cols[j]
                for row in np.nonzero(np.abs(colv) > threshold)[0]:
                    v = complex(colv[row])
                    f.write(f"{start + j + 1} {row + 1} {v.real:.10f} {v.imag:.10f}\n")


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot TOML-serialize {type(v)}")


def dump_toml(cfg: dict) -> str:
    """Minimal TOML rendering of a parsed config dict, for persisting the
    input file verbatim-equivalent into the datafolder when the caller passed
    a dict instead of a path (the reference stores the original TOML,
    ProcessInputFile.jl:50). Round-trips through ``tomllib`` for every config
    shape the schema uses (scalars, arrays, tables, arrays-of-tables)."""
    lines: list[str] = []

    def emit_table(prefix: str, d: dict):
        scalars = {k: v for k, v in d.items()
                   if not isinstance(v, dict)
                   and not (isinstance(v, list) and v
                            and isinstance(v[0], dict))}
        if prefix and (scalars or not d):
            lines.append(f"[{prefix}]")
        for k, v in scalars.items():
            lines.append(f"{k} = {_toml_value(v)}")
        if scalars:
            lines.append("")
        for k, v in d.items():
            if isinstance(v, dict):
                emit_table(f"{prefix}.{k}" if prefix else k, v)
            elif isinstance(v, list) and v and isinstance(v[0], dict):
                name = f"{prefix}.{k}" if prefix else k
                for item in v:
                    lines.append(f"[[{name}]]")
                    for kk, vv in item.items():
                        lines.append(f"{kk} = {_toml_value(vv)}")
                    lines.append("")

    emit_table("", cfg)
    return "\n".join(lines) + "\n"
