"""Chain-steps of every solve finished in the window over the window's seconds (host clock)."""


def read(run):
    n = run.window["counts"].get("chain_steps")
    return n / run.window["seconds"] if n else None
