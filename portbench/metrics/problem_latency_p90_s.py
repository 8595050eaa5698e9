"""problem_latency_p90_s (s, host clock): the 90th percentile over the
window's problems of the time from each problem's scheduled arrival to
its voted answer."""
from portbench.bounds import percentile


def read(rec: dict):
    return percentile([p["finished_s"] - p["arrival_s"]
                       for p in rec["problems"]], 90)
