#!/usr/bin/env python3
"""Every elementwise backward in the JAX package's bf16 train steps, and
how far the port's counterpart is from it.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_bf16_backward_ops.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_bf16_backward_ops.py \\
        tinyllama-1.1b mamba2-130m --json
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_bf16_backward_ops.py \\
        --primitives --mamba2 --no-archs

For each arch (default: all of the JAX package's), its smoke config in
bf16: the loss of a batch of ``--batch`` rows of ``--seq`` tokens (vlm
with ``patch_embeds``, encdec with ``enc_frames``) is traced to a jaxpr,
nothing compiled.  Every primitive of `PRIMITIVES` whose operand depends
on the parameters, so that its transpose lies on the backward path, is
listed by site: the innermost frame in the JAX package (file:line and
function), the JAX function that issues it (``silu``, ``gelu``,
``softmax``, ``logsumexp``, ``softplus``, or the primitive itself), and
its operand's type and shape.  A norm's primitives are one site, the
norm.

Each site is then held against the port's counterpart (file:line) op by
op: seeded inputs of the site's shapes and types and a seeded cotangent
go through the JAX function compiled with each op rounding to its type
(``xla_allow_excess_precision`` off, the reference of
``tests/jax_per_op.py``) and through the port's, under ``jax.vjp`` and
``torch.autograd``.  Printed: each input gradient's elements apart, the
largest distance in ulps of its type, and for f32 the elements apart
once both are rounded to bf16 (where an f32 gradient meets the model's
bf16 tensors).  The fate: ``bitwise``, or ``not reproducible`` with the
cause (ROADMAP "Not faults").

``--primitives`` prints, for XLA's f32 ``exp``, ``log``, ``log1p``,
``rsqrt`` and ``tanh`` on the CPU, how many of 65,536 seeded values
differ from the correctly rounded result and from torch's, and how far:
the measurement that says why no op order makes an f32 site bitwise.
``--mamba2`` compares each intermediate of one bf16 mamba2-130m smoke
mixer with the per-op JAX program, on the same input and weights: all
the way through, and each op given the JAX program's own inputs (its
own share).  ``--json`` prints one JSON object per arch and section.
Like the other tools, this script imports both packages; the port
itself imports no JAX.
"""

import argparse
import ast
import dataclasses
import functools
import inspect
import json
import re
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402
from jax._src import core  # noqa: E402

from repro.configs import REGISTRY, get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import init_params  # noqa: E402
from repro.models.steps import loss_fn  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402

#: the primitives whose backward the audit follows
PRIMITIVES = ("logistic", "exp", "log", "log1p", "rsqrt", "tanh",
              "integer_pow", "div", "cumsum")
#: JAX functions held whole (the API frame's name)
API_UNITS = ("silu", "gelu", "softmax", "logsumexp", "softplus")
#: the MoE's gate renormalization, ``g / max(sum(g, -1), 1e-9)`` (a
#: ``div`` in a MoE function of the JAX package), is held whole too
#: functions of the JAX package held whole (the site's function)
FUNC_UNITS = ("rms_norm", "layer_norm")
#: the port's function of a JAX function where the names differ
PORT_FUNC = {"_moe_gspmd": "_moe_rows", "_moe_ep_shardmap": "_moe_rows"}
#: a line of the port's function that holds a unit's counterpart
PORT_TOKEN = {"silu": r"_silu\(", "gelu": r"_gelu\(",
              "softmax": r"torch\.softmax", "logsumexp": r"torch\.logsumexp",
              "softplus": r"_softplus\(", "rms_norm": r"torch\.rsqrt",
              "layer_norm": r"torch\.rsqrt", "exp": r"torch\.exp",
              "log": r"torch\.log\(", "log1p": r"log1p", "tanh": r"tanh",
              "rsqrt": r"torch\.rsqrt", "logistic": r"_sigmoid\(",
              "integer_pow": r"\*\*", "div": r"[^/]/[^/]",
              "gate_renorm": r"_renorm\(",
              "cumsum": r"torch\.cumsum"}
#: the f32 primitives whose XLA CPU value is an approximation of its own
#: (``--primitives``); a site holding one cannot be bitwise in f32
APPROXIMATE = ("exp", "log", "log1p", "rsqrt", "tanh", "logistic")
_WRAPPERS = {"traceback_util.py", "pjit.py", "partial_eval.py", "api.py",
             "core.py", "source_info_util.py", "linear_util.py",
             "custom_derivatives.py", "api_util.py", "profiler.py"}
_OPTIONS = {"xla_allow_excess_precision": False}


def per_op(fun, *args):
    """``fun(*args)`` compiled with each op rounding to its type."""
    return jax.jit(fun).lower(*args).compile(
        compiler_options=_OPTIONS)(*args)


# ------------------------------------------------------------ the sites ---

def _rel(path: str) -> str:
    try:
        return str(Path(path).resolve().relative_to(ROOT))
    except ValueError:
        return path


def _where(eqn):
    """``(file, line, function, api, caller)``: the innermost frame in the
    JAX package, the name of the function it calls (the first frame
    inside it that is not JAX's tracing machinery), and the next frame
    out in the JAX package (``file:line``)."""
    frames = eqn.source_info.traceback.frames if \
        eqn.source_info.traceback else []
    ours = [i for i, f in enumerate(frames) if "/src/repro/" in f.file_name]
    if not ours:
        return "?", 0, "?", eqn.primitive.name, "?"
    i, f = ours[0], frames[ours[0]]
    api = eqn.primitive.name
    for g in reversed(frames[:i]):
        if Path(g.file_name).name not in _WRAPPERS:
            api = g.function_name
            break
    caller = "?"
    if len(ours) > 1:
        c = frames[ours[1]]
        caller = f"{_rel(c.file_name)}:{c.line_num}"
    return _rel(f.file_name), f.line_num, f.function_name, api, caller


def _subjaxprs(eqn):
    out = []
    for v in eqn.params.values():
        for j in (v if isinstance(v, (tuple, list)) else [v]):
            if isinstance(j, core.ClosedJaxpr):
                out.append(j.jaxpr)
            elif isinstance(j, core.Jaxpr):
                out.append(j)
    return out


def _walk(jaxpr, taint, sites, record=True):
    """Follow which values depend on the parameters through ``jaxpr``
    (``taint``: one flag per input) and add each tainted primitive of
    `PRIMITIVES` to ``sites``; returns the outputs' flags."""
    t = dict(zip(jaxpr.invars, taint))

    def tainted(a):
        return isinstance(a, core.Var) and t.get(a, False)
    for eqn in jaxpr.eqns:
        ins = [tainted(a) for a in eqn.invars]
        subs = _subjaxprs(eqn)
        outs = [any(ins)] * len(eqn.outvars)
        if subs and eqn.primitive.name == "scan":
            nc, ncar = eqn.params["num_consts"], eqn.params["num_carry"]
            cin = list(ins)
            while True:                       # a carry's flag to a fixpoint
                res = _walk(subs[0], cin, sites, record=False)
                nxt = [a or (nc <= i < nc + ncar and res[i - nc])
                       for i, a in enumerate(cin)]
                if nxt == cin:
                    break
                cin = nxt
            outs = _walk(subs[0], cin, sites, record)
        elif len(subs) == 1 and len(subs[0].invars) == len(ins):
            outs = _walk(subs[0], ins, sites, record)
        else:
            for s in subs:
                _walk(s, [any(ins)] * len(s.invars), sites, record)
        if (record and eqn.primitive.name in PRIMITIVES and any(ins)
                and jnp.issubdtype(eqn.outvars[0].aval.dtype, jnp.floating)):
            file, line, fn, api, caller = _where(eqn)
            sites.append({"file": file, "line": line, "function": fn,
                          "api": api, "caller": caller,
                          "primitive": eqn.primitive.name,
                          "eqn": eqn, "tainted": ins})
        for v, x in zip(eqn.outvars, outs):       # ints carry no gradient
            t[v] = x and jnp.issubdtype(v.aval.dtype, jnp.inexact)
    return [tainted(v) for v in jaxpr.outvars]


def _first_input(jaxpr, where):
    """The aval of the first floating input of the first primitive issued
    from ``where`` (file, function, caller) in ``jaxpr``: a norm's input,
    in the model's type."""
    for eqn in jaxpr.eqns:
        here = _where(eqn)
        if (here[0], here[2], here[4]) == where:
            for a in eqn.invars:
                if isinstance(a, core.Var) and jnp.issubdtype(
                        a.aval.dtype, jnp.floating):
                    return a.aval
        for s in _subjaxprs(eqn):
            got = _first_input(s, where)
            if got is not None:
                return got
    return None


def trace(arch: str, batch: int, seq: int):
    """``(cfg, closed jaxpr, sites)`` of ``arch``'s bf16 smoke loss."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    params = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    ints = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    b = {"tokens": ints, "labels": ints}
    if cfg.family == "vlm":
        b["patch_embeds"] = jax.ShapeDtypeStruct(
            (batch, cfg.n_patches, cfg.d_model), jnp.float32)
    if cfg.family == "encdec":
        b["enc_frames"] = jax.ShapeDtypeStruct(
            (batch, cfg.encoder_seq, cfg.d_model), jnp.float32)
    closed = jax.make_jaxpr(lambda p, bb: loss_fn(p, cfg, bb)[0])(params, b)
    n = len(jax.tree.leaves(params))
    taint = [i < n for i in range(len(closed.jaxpr.invars))]
    sites = []
    _walk(closed.jaxpr, taint, sites)
    return cfg, closed, sites


def _unit(s) -> str:
    if s["api"] in API_UNITS:
        return s["api"]
    if s["function"] in FUNC_UNITS:
        return s["function"]
    if s["primitive"] == "div" and s["function"].startswith("_moe_"):
        return "gate_renorm"
    return s["primitive"]


def group(closed, sites):
    """One entry per site: a JAX function or a norm, or a lone
    primitive, with its lines, primitives, operands and count."""
    out = {}
    for s in sites:
        unit = _unit(s)
        eqn = s["eqn"]
        ops = [(tuple(a.aval.shape), str(a.aval.dtype), tainted,
                float(np.asarray(a.val)) if isinstance(a, core.Literal)
                else None)
               for a, tainted in zip(eqn.invars, s["tainted"])]
        if unit in FUNC_UNITS:
            key = (s["file"], s["function"], unit, s["caller"])
            x = _first_input(closed.jaxpr,
                             (s["file"], s["function"], s["caller"]))
            ops = [(tuple(x.shape), str(x.dtype), True, None)]
        elif unit in API_UNITS or unit == "gate_renorm":
            key, ops = (s["file"], s["line"], unit), ops[:1]
        else:
            key = (s["file"], s["line"], unit, tuple(o[:3] for o in ops))
        e = out.setdefault(key, {
            "file": s["file"], "lines": set(), "function": s["function"],
            "api": s["api"], "caller": s["caller"], "unit": unit,
            "primitives": [], "operands": ops,
            "params": dict(eqn.params) if unit == s["primitive"] else {},
            "count": 0})
        e["lines"].add(s["line"])
        if s["primitive"] not in e["primitives"]:
            e["primitives"].append(s["primitive"])
        e["count"] += 1
    return list(out.values())


# ------------------------------------------------- the port's counterpart ---

@functools.lru_cache(maxsize=None)
def _code_lines(module, name: str):
    """``[(line number, code)]`` of the port's function ``name`` in
    ``module``, its docstring and comments left out."""
    fn = getattr(module, name, None)
    if fn is None:
        return []
    src, start = inspect.getsourcelines(fn)
    body = ast.parse(textwrap.dedent("".join(src))).body[0].body
    skip = set()
    if isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                    ast.Constant):
        skip = set(range(body[0].lineno, body[0].end_lineno + 1))
    return [(start + i, line.split("#")[0]) for i, line in enumerate(src)
            if i + 1 not in skip]


def port_site(entry, index: int) -> str:
    """The port's file:line for a site: the ``index``-th line of the
    port's function of the same name holding the unit's counterpart."""
    mod = {"models/layers.py": TL, "models/steps.py": TS}.get(
        entry["file"].split("src/repro/", 1)[-1])
    if mod is None:
        return "?"
    name = PORT_FUNC.get(entry["function"].split(".<locals>")[0],
                         entry["function"].split(".<locals>")[0])
    token = r"torch\.mean" if entry["api"] == "mean" else PORT_TOKEN[
        entry["unit"]]
    hits = [n for n, code in _code_lines(mod, name) if re.search(token, code)]
    if not hits:
        return "?"
    line = hits[min(index, len(hits) - 1)]
    return f"{_rel(inspect.getsourcefile(mod))}:{line}"


# ------------------------------------------------------ the comparisons ---

_TORCH_PRIM = {
    "exp": torch.exp, "log": torch.log, "log1p": torch.log1p,
    "rsqrt": torch.rsqrt, "tanh": torch.tanh, "logistic": TL._sigmoid,
    "integer_pow": lambda x, y: x ** y, "div": lambda a, b: a / b,
    "cumsum": lambda x, axis, reverse=False: (
        torch.flip(torch.cumsum(torch.flip(x, [axis]), axis), [axis])
        if reverse else torch.cumsum(x, axis))}
_JDT = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
_TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _values(rng, shape, unit: str, k: int):
    """Seeded inputs where the unit takes them: positive where it takes a
    log, a root or a divisor, logits of a realistic spread elsewhere."""
    x = rng.normal(size=shape)
    if unit in ("log", "rsqrt") or (unit == "div" and k == 1):
        return np.abs(x) + 0.05
    if unit == "gate_renorm":
        return 0.3 * np.abs(x)
    if unit == "log1p":
        return np.abs(x)
    return 3 * x if unit in ("exp", "softmax", "logsumexp", "softplus",
                             "silu", "gelu", "logistic", "tanh") else x


def _functions(entry, consts):
    """``(jax function, port function)`` of a site's parameter-dependent
    operands; ``consts`` holds each other operand's ``(f32 value,
    type)`` (None for a dependent one)."""
    unit = entry["unit"]
    if unit == "rms_norm":
        return JL.rms_norm, TL.rms_norm
    if unit == "layer_norm":
        return JL.layer_norm, TL.layer_norm
    if unit == "gate_renorm":
        return (lambda g: g / jnp.maximum(g.sum(-1, keepdims=True), 1e-9),
                TL._renorm)
    if unit in API_UNITS:
        jf = {"silu": jax.nn.silu, "gelu": jax.nn.gelu,
              "softmax": lambda x: jax.nn.softmax(x, axis=-1),
              "logsumexp": lambda x: jax.scipy.special.logsumexp(x, -1),
              "softplus": jax.nn.softplus}[unit]
        tf = {"silu": TL._silu, "gelu": TL._gelu,
              "softmax": lambda x: torch.softmax(x, -1),
              "logsumexp": lambda x: torch.logsumexp(x, -1),
              "softplus": TL._softplus}[unit]
        return jf, tf
    prim, params = getattr(lax, f"{unit}_p"), entry["params"]

    def fill(args, lib):
        it = iter(args)
        return [next(it) if c is None else lib(*c) for c in consts]

    def jf(*args):
        return prim.bind(*fill(args, lambda v, dt: jnp.asarray(v, _JDT[dt])),
                         **params)

    def tf(*args):
        xs = fill(args, lambda v, dt: torch.tensor(v).to(_TDT[dt]))
        return _TORCH_PRIM[unit](*xs, **params)
    return jf, tf


def _ulps(a: np.ndarray, b: np.ndarray, dtype: str) -> int:
    """The largest distance in ulps of ``dtype`` between f32 arrays
    holding values of that type."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        if dtype == "bfloat16":
            i = i >> 16
        sign = 1 << (15 if dtype == "bfloat16" else 31)
        return np.where(i < 0, -(i & (sign - 1)), i)
    return int(np.abs(key(a) - key(b)).max()) if a.size else 0


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def compare(unit: str, operands, params_items) -> list:
    """One record per differentiated operand of a site (``operands``:
    ``(shape, type, depends on the parameters, literal value)`` each):
    its gradient's elements apart, largest ulps and elements apart as
    bf16, the port's against the per-op JAX ``vjp`` on seeded inputs and
    cotangent (the same for every site of one shape)."""
    entry = {"unit": unit, "params": dict(params_items)}
    rng = np.random.default_rng(0)
    ins, consts = [], []
    for k, (shape, dtype, tainted, lit) in enumerate(operands):
        v = np.asarray(lit if lit is not None else _values(
            rng, shape, unit, k), np.float32)
        if dtype == "bfloat16":
            v = _bf16(v)
        if tainted:
            ins.append((v, dtype))
        consts.append(None if tainted else (v, dtype))
    jf, tf = _functions(entry, consts)
    if unit in FUNC_UNITS:                # the norm's f32 weight (and bias)
        d = ins[0][0].shape[-1]
        ins += [(1 + 0.1 * rng.normal(size=(d,)).astype(np.float32),
                 "float32")]
        if unit == "layer_norm":
            ins += [(0.1 * rng.normal(size=(d,)).astype(np.float32),
                     "float32")]
    jins = [jnp.asarray(v, _JDT[dt]) for v, dt in ins]
    out = jax.eval_shape(jf, *jins)
    cot = rng.normal(size=out.shape).astype(np.float32)
    jc = jnp.asarray(cot, out.dtype)
    want = per_op(lambda *a: jax.vjp(jf, *a[:-1])[1](a[-1]), *jins, jc)
    tins = [torch.tensor(v).to(_TDT[dt]).requires_grad_(True)
            for v, dt in ins]
    y = tf(*tins)
    got = torch.autograd.grad(y, tins, torch.tensor(np.asarray(
        jc.astype(jnp.float32))).to(y.dtype))
    res = []
    for (v, dt), w, g in zip(ins, want, got):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        res.append({"dtype": dt, "shape": list(w.shape), "size": int(w.size),
                    "apart": int((w != g).sum()),
                    "max_ulps": _ulps(w, g, dt),
                    "apart_bf16": int((_bf16(w) != _bf16(g)).sum())})
    return res


#: the port's autograd Functions that follow the JAX package's backward
REPAIRED = {"silu": "_Silu", "gelu": "_Gelu", "gate_renorm": "_Renorm"}


def fate(entry, apart: int) -> str:
    """``bitwise`` (``repaired`` where a Function of the port makes it
    so), or why not (ROADMAP "Not faults")."""
    unit = entry["unit"]
    if apart == 0:
        return (f"repaired, bitwise ({REPAIRED[unit]})" if unit in REPAIRED
                else "bitwise")
    if unit == "cumsum":
        return ("not repaired: XLA's CPU cumsum is a sequential chain, "
                "which a chain of adds reproduces alone, but the scan's f32 "
                "exp and products around it are not reproducible")
    prims = set(entry["primitives"]) | {
        "softmax": {"exp"}, "logsumexp": {"exp", "log"},
        "softplus": {"exp", "log1p"}, "silu": {"exp"}, "gelu": {"tanh"},
        "rms_norm": {"rsqrt"}, "layer_norm": {"rsqrt"}}.get(unit, set())
    approx = sorted(prims & set(APPROXIMATE) - {"logistic"})
    parts = []
    if approx:
        parts.append(f"XLA's f32 {'/'.join(approx)} is its own "
                     "approximation (--primitives)")
    if unit in ("softmax", "logsumexp", "rms_norm", "layer_norm"):
        parts.append("its f32 sums run in XLA's order")
    if not parts:
        parts.append("XLA's f32 op order and fused multiply-adds")
    done = (f"; {REPAIRED[unit]} follows XLA's op order"
            if unit in REPAIRED else "")
    return "not reproducible: " + "; ".join(parts) + done


def audit(arch: str, batch: int = 2, seq: int = 16) -> dict:
    """``arch``'s elementwise backward sites, each held against the
    port's counterpart."""
    t0 = time.perf_counter()
    _, closed, sites = trace(arch, batch, seq)
    entries = sorted(group(closed, sites),
                     key=lambda e: (e["file"], min(e["lines"])))
    seen = {}
    out = []
    for e in entries:
        fn = e["function"].split(".<locals>")[0]
        k = (e["file"], fn, e["unit"])
        idx = seen[k] = seen.get(k, -1) + 1
        cmp = compare(
            e["unit"], tuple(tuple(o) for o in e["operands"]),
            tuple(sorted((k_, v) for k_, v in e["params"].items()
                         if isinstance(v, (int, bool, str)))))
        apart = sum(r["apart"] for r in cmp)
        out.append({
            "site": f"{e['file']}:{','.join(map(str, sorted(e['lines'])))}",
            "function": e["function"], "caller": e["caller"],
            "unit": e["unit"],
            "primitives": e["primitives"], "count": e["count"],
            "operands": [f"{o[1]}{list(o[0])}" for o in e["operands"]
                         if o[2]],
            "port": port_site(e, idx), "gradients": cmp,
            "fate": fate(e, apart)})
    return {"arch": arch, "dtype": "bfloat16", "batch": batch, "seq": seq,
            "sites": out, "seconds": time.perf_counter() - t0}


# ------------------------------------------------- the f32 primitives ---

def primitives(n: int = 65_536) -> dict:
    """XLA's f32 transcendental primitives on the CPU against the
    correctly rounded value (numpy in f64, rounded) and torch's."""
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=n)).astype(np.float32)
    pos = np.abs(x) + np.float32(0.01)
    rows = []
    for name, jf, tf, nf, v in [
            ("exp", jnp.exp, torch.exp, np.exp, x),
            ("log", jnp.log, torch.log, np.log, pos),
            ("log1p", jnp.log1p, torch.log1p, np.log1p, pos),
            ("rsqrt", lax.rsqrt, torch.rsqrt,
             lambda a: 1 / np.sqrt(a), pos),
            ("tanh", jnp.tanh, torch.tanh, np.tanh, x)]:
        xla = np.asarray(per_op(jf, v))
        exact = nf(v.astype(np.float64)).astype(np.float32)
        port = tf(torch.from_numpy(v)).numpy()
        rows.append({"primitive": name, "n": n,
                     "xla_vs_correctly_rounded": int((xla != exact).sum()),
                     "xla_max_ulps": _ulps(xla, exact, "float32"),
                     "torch_vs_correctly_rounded": int((port != exact).sum()),
                     "xla_vs_torch": int((xla != port).sum()),
                     "xla_vs_torch_max_ulps": _ulps(xla, port, "float32")})
    return {"section": "primitives", "rows": rows}


# ------------------------------------------------- mamba2's forward ---

def mamba2_forward(batch: int = 2, seq: int = 64) -> dict:
    """One bf16 mamba2-130m smoke mixer (1 layer, the JAX weights, a
    seeded input): each intermediate in the JAX program's order, apart
    from the per-op JAX program all the way through (``through``) and
    with each op given the JAX program's own inputs (``own``)."""
    jcfg = dataclasses.replace(get_config("mamba2-130m").smoke(),
                               n_layers=1, dtype="bfloat16")
    cfg = dataclasses.replace(port_config("mamba2-130m").smoke(),
                              n_layers=1, dtype="bfloat16")
    params = jax.jit(init_params, static_argnums=0)(jcfg,
                                                    jax.random.PRNGKey(0))
    lp = {k: v[0] for k, v in params["layers"].items()}

    def t(a):
        return torch.tensor(np.asarray(jnp.asarray(a).astype(
            jnp.float32))).to(_TDT[str(a.dtype)])
    tp = {k: t(v) for k, v in lp.items()}
    di, H, P = jcfg.d_inner, jcfg.ssm_heads, jcfg.ssm_head_dim
    chunk = min(jcfg.ssm_chunk, seq)
    x = _bf16(np.random.default_rng(0).normal(size=(batch, seq,
                                                    jcfg.d_model)))

    def jax_steps(x):
        p = lp
        out = {"z": jnp.einsum("bsd,de->bse", x, p["wz"]),
               "xh": jnp.einsum("bsd,de->bse", x, p["wx"]).reshape(
                   batch, seq, H, P),
               "Bm": jnp.einsum("bsd,dn->bsn", x, p["wB"]),
               "Cm": jnp.einsum("bsd,dn->bsn", x, p["wC"]),
               "dt_in": jnp.einsum("bsd,dh->bsh", x, p["wdt"])}
        out["dt"] = jax.nn.softplus(out["dt_in"].astype(jnp.float32)
                                    + p["dt_bias"])
        out["A"] = -jnp.exp(p["A_log"].astype(jnp.float32))
        out["y"] = JL._ssd_chunk_scan(out["xh"], out["dt"], out["A"],
                                      out["Bm"], out["Cm"], chunk)[0]
        out["y_D"] = (out["y"] + out["xh"] * p["D"][None, None, :, None]
                      .astype(x.dtype)).reshape(batch, seq, di)
        out["gate"] = jax.nn.silu(out["z"].astype(jnp.float32)).astype(
            out["y_D"].dtype)
        out["y_gated"] = out["y_D"] * out["gate"]
        out["norm"] = JL.rms_norm(out["y_gated"], p["norm_w"])
        out["out"] = jnp.einsum("bse,ed->bsd", out["norm"], p["out_proj"])
        return out

    def port_steps(x, j=None):
        """The port's ops on ``x``; with ``j`` (the JAX intermediates as
        tensors) each op takes the JAX program's inputs instead."""
        p, o = tp, {}

        def src(k):
            return j[k] if j is not None else o[k]
        o["z"] = x @ p["wz"]
        o["xh"] = (x @ p["wx"]).reshape(batch, seq, H, P)
        o["Bm"], o["Cm"] = x @ p["wB"], x @ p["wC"]
        o["dt_in"] = x @ p["wdt"]
        o["dt"] = TL._softplus(src("dt_in").float() + p["dt_bias"])
        o["A"] = -torch.exp(p["A_log"].float())
        o["y"] = TL._ssd_chunk_scan(src("xh"), src("dt"), src("A"),
                                    src("Bm"), src("Cm"), chunk)[0]
        o["y_D"] = (src("y") + src("xh") * p["D"][None, None, :, None].to(
            x.dtype)).reshape(batch, seq, di)
        o["gate"] = TL._silu(src("z").float()).to(x.dtype)
        o["y_gated"] = src("y_D") * src("gate")
        o["norm"] = TL.rms_norm(src("y_gated"), p["norm_w"])
        o["out"] = src("norm") @ p["out_proj"]
        return o

    want = per_op(jax_steps, jnp.asarray(x, jnp.bfloat16))
    jt = {k: t(v) for k, v in want.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        through, own = port_steps(xt), port_steps(xt, jt)
    rows = []
    for k in through:                     # in the JAX program's order
        w = np.asarray(want[k].astype(jnp.float32))
        rows.append({"value": k, "dtype": str(want[k].dtype),
                     "size": int(w.size),
                     "through": int((through[k].float().numpy() != w).sum()),
                     "own": int((own[k].float().numpy() != w).sum())})
    return {"section": "mamba2_forward", "batch": batch, "seq": seq,
            "rows": rows}


# ------------------------------------------------------------- the CLI ---

def _print_arch(res: dict) -> None:
    fates = [s["fate"] for s in res["sites"]]
    print(f"{res['arch']}: {len(fates)} elementwise backward sites, "
          f"{sum('bitwise' in f for f in fates)} bitwise, "
          f"{sum(f.startswith('repaired') for f in fates)} of them repaired "
          f"({res['seconds']:.1f} s)")
    for s in res["sites"]:
        grads = "; ".join(
            f"{g['apart']:,} of {g['size']:,} apart ({g['dtype']}, "
            f"{g['max_ulps']} ulps" + (f", {g['apart_bf16']:,} as bf16"
                                       if g["dtype"] == "float32" else "")
            + ")" for g in s["gradients"])
        via = f" from {s['caller']}" if s["unit"] in FUNC_UNITS else ""
        print(f"  {s['site']} {s['function']}{via}: {s['unit']} "
              f"({','.join(s['primitives'])}) {' '.join(s['operands'])} "
              f"x{s['count']}\n      port {s['port']}: {grads}"
              f"\n      {s['fate']}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", help="default: every arch")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--primitives", action="store_true")
    ap.add_argument("--mamba2", action="store_true")
    ap.add_argument("--no-archs", action="store_true",
                    help="only the sections asked for")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    results = []
    for arch in ([] if args.no_archs else args.archs or sorted(REGISTRY)):
        res = audit(arch, args.batch, args.seq)
        results.append(res)
        if args.json:
            print(json.dumps(res), flush=True)
        else:
            _print_arch(res)
    for want, fn in ((args.primitives, primitives),
                     (args.mamba2, mamba2_forward)):
        if not want:
            continue
        res = fn()
        results.append(res)
        if args.json:
            print(json.dumps(res), flush=True)
            continue
        print(res["section"] + ":")
        for r in res["rows"]:
            print("  " + ", ".join(f"{k} {v}" for k, v in r.items()))
    return results


if __name__ == "__main__":
    main()
