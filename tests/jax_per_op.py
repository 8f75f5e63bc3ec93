"""The JAX package's programs as their source writes them, each op
rounding to its type: the reference of the port's 16-bit gradients.

XLA's CPU compiler may keep a bf16 intermediate in f32 inside a fusion
(``xla_allow_excess_precision``, on by default), so what the default
``jax.jit`` of a bf16 function computes depends on XLA's fusion choices:
a 1-layer bf16 tinyllama-1.1b smoke forward so compiled is thousands of
elements from the same program run op by op.  `per_op` compiles with
that option off, which gives the op-by-op program's values bitwise
(``jax.disable_jit()``; ``tests/test_torch_bf16_backward.py`` holds it)
in a fraction of the time.  Each op's own arithmetic is still XLA's: its
f32 ``exp``, ``log``, ``rsqrt`` and ``tanh`` approximations, its f32
fused multiply-adds and its products' summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np

OPTIONS = {"xla_allow_excess_precision": False}


def compile_per_op(fun, *args):
    """``fun`` lowered at ``args`` and compiled with XLA's excess precision
    off (the executable takes ``args``' leaves as ``fun`` takes them)."""
    return jax.jit(fun).lower(*args).compile(compiler_options=OPTIONS)


def per_op(fun):
    """``fun``, jitted, compiled by `compile_per_op` once per signature of
    its arguments (their tree, shapes and types)."""
    cache = {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), jnp.result_type(a))
                           for a in leaves))
        if key not in cache:
            cache[key] = compile_per_op(fun, *args)
        return cache[key](*args)
    return call
