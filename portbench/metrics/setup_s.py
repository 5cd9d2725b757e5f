"""Seconds from the start of the process to the first timed request (host
clock), less the set-up the reference's own work took (its PCA and basis,
the targets it renders)."""


def read(run):
    return run.setup_s
