"""tokens_per_s (tokens/s, host clock): every token the window's problems
generated, by every trace including the pruned ones, over the window's
seconds (closed loop: until the problem in flight at --seconds was
answered; open loop: until the last problem that arrived was answered)."""


def read(rec: dict):
    if not rec["problems"] or rec["window_s"] <= 0:
        return None
    return sum(p["tokens"] for p in rec["problems"]) / rec["window_s"]
