"""Shared by the per-layer readers of a traced run: the parts of the
window that the profiler left alone. Its start stalls the host for
seconds, and with it on, each decode graph's replay takes several times
as long on the host, so the device idles for the profiler: the readers of
host times, idle time and the step's whole rate read the part of the
window before the profiled stretch began."""


def stretch_start(rec: dict):
    prof = rec.get("profile")
    return None if not prof else prof["host_s"][0]


def unprofiled(rec: dict) -> list:
    """The window's problems answered before the profiled stretch began
    (seconds from the window's start)."""
    start = stretch_start(rec)
    if start is None:
        return list(rec["problems"])
    start -= rec["origin_s"]
    return [p for p in rec["problems"] if p["finished_s"] < start]


def before_stretch(rec: dict, key: str) -> list:
    """The ticks or prefills (``key``) that ran, with their device times,
    before the profiled stretch began."""
    start = stretch_start(rec)
    return [t for t in rec[key] if not t["traced"] and t["d0"] is not None
            and (start is None or t["t1"] < start)]
