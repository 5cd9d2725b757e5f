"""Images delivered as uint8 on the host in the window over the window's seconds (host clock)."""


def read(run):
    n = run.window["counts"].get("images")
    return n / run.window["seconds"] if n else None
