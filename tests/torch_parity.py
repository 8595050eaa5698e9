"""Shared helpers of the PyTorch port's parity tests: inputs made once with
numpy and handed to both the JAX package and the port."""
import jax.numpy as jnp
import numpy as np
import torch

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def pair(x, dt="f32"):
    """One numpy array -> (jax array, torch tensor) of the same values."""
    jd, td = DTYPES[dt]
    return jnp.asarray(x, jd), torch.from_numpy(np.array(x)).to(td)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def decode_case(seed, B, H, KVH, hd, page, bp, lens=None, dt="f32"):
    rs = np.random.RandomState(seed)
    NB = B * bp + 2
    q = rs.randn(B, H, hd).astype(np.float32)
    kp = rs.randn(NB, page, KVH, hd).astype(np.float32)
    vp = rs.randn(NB, page, KVH, hd).astype(np.float32)
    bt = rs.permutation(NB)[:B * bp].reshape(B, bp).astype(np.int32)
    if lens is None:
        lens = rs.randint(1, page * bp + 1, B)
    lens = np.asarray(lens, np.int32)
    j = [pair(q, dt), pair(kp, dt), pair(vp, dt)]
    return ([a for a, _ in j] + [jnp.asarray(bt), jnp.asarray(lens)],
            [b for _, b in j] + [torch.from_numpy(bt), torch.from_numpy(lens)])


def prefill_case(seed, B, C, KVH, G, page, bp, starts, nvalid, dt="f32",
                 hd=32):
    rs = np.random.RandomState(seed)
    H = KVH * G
    NB = B * bp + 2
    arrs = [rs.randn(B, C, H, hd), rs.randn(NB, page, KVH, hd),
            rs.randn(NB, page, KVH, hd)]
    own = [rs.randn(B, C, KVH, hd), rs.randn(B, C, KVH, hd)]
    bt = rs.permutation(NB)[:B * bp].reshape(B, bp).astype(np.int32)
    ints = [bt, np.asarray(starts, np.int32), np.asarray(nvalid, np.int32)]
    jf = [pair(a.astype(np.float32), dt) for a in arrs + own]
    jargs = [p[0] for p in jf[:3]] + [jnp.asarray(i) for i in ints] + \
        [p[0] for p in jf[3:]]
    targs = [p[1] for p in jf[:3]] + [torch.from_numpy(i) for i in ints] + \
        [p[1] for p in jf[3:]]
    return jargs, targs
