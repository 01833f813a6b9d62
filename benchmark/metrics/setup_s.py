"""Set-up seconds: process start to the window's start (imports, the port's
build of the cell, the kernels' build and tuning, the graph captures, the
warm-up steps). Host clock."""


def read(record):
    return record.setup_s
