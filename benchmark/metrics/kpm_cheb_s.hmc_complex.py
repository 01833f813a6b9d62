"""Device seconds per update of the complex KPM recurrence: the
``kpm.cheb_complex`` marks the port captures around each complex Chebyshev
pass (``ops/kpm._chebyshev_apply``), as their share of each graph's last
replay times that graph's device seconds in the traced update. None where
no graph holds the mark (a port without it)."""

from harness.port_spans import marked_s, update_record

LABEL = "kpm.cheb_complex"


def read(record):
    rec = update_record(record)
    if rec is None or not any(LABEL in marks for marks in rec.marks.values()):
        return None
    return marked_s(record, (LABEL,))
