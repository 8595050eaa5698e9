"""setup_s (s, host clock): process start to the first timed request:
imports, the weights made on the card, the kernels loaded (built, in a
checkout's first run), the engine and the mix's warm-up."""


def read(rec: dict):
    return rec["setup_s"]
