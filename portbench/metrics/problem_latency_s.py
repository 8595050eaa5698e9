"""problem_latency_s (s, host clock): mean time from a problem's
submission to its voted answer, over the window's problems (the paper's
average end-to-end latency per problem)."""


def read(rec: dict):
    lat = [p["finished_s"] - p["arrival_s"] for p in rec["problems"]]
    return sum(lat) / len(lat) if lat else None
