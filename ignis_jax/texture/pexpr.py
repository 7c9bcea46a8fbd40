"""PExpr shading-expression engine.

The reference transpiles PExpr strings to Artic source at scene-load time
(src/runtime/loader/Transpiler.cpp).  Here, PExpr lowers to traced JAX
functions instead: a small Pratt parser builds a typed DAG once per scene,
and evaluation runs batched over all lanes.  Language spec:
docs/src/scene/pexpr.rst; internal variables Transpiler.cpp:261-287,
function table Transpiler.cpp:566-808.

Types: bool/int/num/vec2/vec3/vec4/str; only int→num implicit casts.
Values are (kind, jnp array) with a trailing component axis for vectors.
"""

from __future__ import annotations

import math
import re

import jax
import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import HIGHEST

_TOKEN_RE = re.compile(r"""
    (?P<float>\d+\.\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>"[^"]*"|'[^']*')
  | (?P<op>\|\||&&|==|!=|<=|>=|[-+*/%^<>!(),.])
  | (?P<ws>\s+)
""", re.X)

_VEC_SIZE = {"num": 1, "vec2": 2, "vec3": 3, "vec4": 4}


class PExprError(ValueError):
    pass


def tokenize(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise PExprError(f"Bad token at {src[pos:pos+10]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append((m.lastgroup, m.group()))
    toks.append(("eof", ""))
    return toks


# ------------------------------------------------------------------- parser

class Node:
    __slots__ = ("op", "args", "value")

    def __init__(self, op, args=(), value=None):
        self.op = op
        self.args = args
        self.value = value


_BINARY_PREC = {
    "||": 1, "&&": 2,
    "==": 3, "!=": 3, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "+": 5, "-": 5, "*": 6, "/": 6, "%": 6, "^": 7,
}


class Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise PExprError(f"Expected {val!r}, got {t[1]!r}")

    def parse(self):
        e = self.expr(0)
        if self.peek()[0] != "eof":
            raise PExprError(f"Trailing tokens: {self.peek()[1]!r}")
        return e

    def expr(self, min_prec):
        lhs = self.unary()
        while True:
            kind, val = self.peek()
            prec = _BINARY_PREC.get(val)
            if kind != "op" or prec is None or prec < min_prec:
                return lhs
            self.next()
            rhs = self.expr(prec + 1)
            lhs = Node("bin", (lhs, rhs), val)

    def unary(self):
        kind, val = self.peek()
        if kind == "op" and val in ("-", "+", "!"):
            self.next()
            inner = self.unary()
            if val == "+":
                return inner
            return Node("neg" if val == "-" else "not", (inner,))
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            kind, val = self.peek()
            if kind == "op" and val == ".":
                self.next()
                member = self.next()
                if member[0] != "name":
                    raise PExprError("Expected member name after '.'")
                node = Node("swizzle", (node,), member[1])
            elif kind == "op" and val == "(" and node.op == "var":
                # call on a name (texture-as-function or builtin handled later)
                self.next()
                args = self.arglist()
                node = Node("call", tuple(args), node.value)
            else:
                return node

    def arglist(self):
        args = []
        if self.peek()[1] == ")":
            self.next()
            return args
        while True:
            args.append(self.expr(0))
            t = self.next()
            if t[1] == ")":
                return args
            if t[1] != ",":
                raise PExprError(f"Expected ',' or ')', got {t[1]!r}")

    def primary(self):
        kind, val = self.next()
        if kind == "float":
            return Node("num", (), float(val))
        if kind == "int":
            return Node("int", (), int(val))
        if kind == "str":
            return Node("str", (), val[1:-1])
        if kind == "name":
            if val == "true":
                return Node("bool", (), True)
            if val == "false":
                return Node("bool", (), False)
            return Node("var", (), val)
        if kind == "op" and val == "(":
            e = self.expr(0)
            self.expect(")")
            return e
        raise PExprError(f"Unexpected token {val!r}")


def parse_pexpr(src: str) -> Node:
    return Parser(tokenize(src)).parse()


# ---------------------------------------------------------------- evaluator

def _kindof(v):
    return v[0]


def _as_num(v):
    k, a = v
    if k == "int":
        return ("num", a.astype(jnp.float32))
    if k == "num":
        return v
    raise PExprError(f"Cannot convert {k} to num")


def _broadcast_pair(a, b):
    """Implicit conversions for binary ops: int→num; num op vecN broadcasts."""
    ka, va = a
    kb, vb = b
    if ka == "int" and kb != "int":
        a = _as_num(a)
    elif kb == "int" and ka != "int":
        b = _as_num(b)
    ka, va = a
    kb, vb = b
    if ka == kb:
        return a, b, ka
    if ka == "num" and kb in ("vec2", "vec3", "vec4"):
        return ("x", va[..., None]), b, kb
    if kb == "num" and ka in ("vec2", "vec3", "vec4"):
        return a, ("x", vb[..., None]), ka
    raise PExprError(f"Type mismatch: {ka} vs {kb}")


_SWIZ = {"x": 0, "y": 1, "z": 2, "w": 3, "r": 0, "g": 1, "b": 2, "a": 3}


def _elemwise(fn):
    def wrap(args):
        v = args[0]
        k, a = _as_num(v) if v[0] == "int" else v
        return (k, fn(a))
    return wrap


def _elemwise2(fn):
    def wrap(args):
        a, b, k = _broadcast_pair(args[0], args[1])
        return (k, fn(a[1], b[1]))
    return wrap


class Evaluator:
    def __init__(self, scene, tables, ctx):
        self.scene = scene
        self.tables = tables
        self.ctx = ctx  # dict of lane arrays

    # ---- variables
    def var(self, name):
        ctx = self.ctx
        simple = {
            "uv": ("vec2", "uv"), "uvw": ("vec3", "uvw"),
            "prim_coords": ("vec2", "prim_coords"),
            "P": ("vec3", "P"), "Np": ("vec3", "Np"),
            "V": ("vec3", "V"), "Rd": ("vec3", "V"), "Ro": ("vec3", "Ro"),
            "N": ("vec3", "N"), "Ng": ("vec3", "Ng"),
            "Nx": ("vec3", "Nx"), "Ny": ("vec3", "Ny"),
            "frontside": ("bool", "frontside"),
            "entity_id": ("int", "entity_id"),
            "Ix": ("int", "Ix"), "Iy": ("int", "Iy"),
            "t": ("num", "t"),
            "frame": ("int", "frame"),
        }
        if name in simple:
            kind, key = simple[name]
            if key in ctx:
                return (kind, ctx[key])
            size = _VEC_SIZE.get(kind, 1)
            n = ctx["uv"].shape[0]
            if kind in ("vec2", "vec3", "vec4"):
                return (kind, jnp.zeros((n, size), jnp.float32))
            if kind == "bool":
                return ("bool", jnp.ones((n,), bool))
            if kind == "int":
                return ("int", jnp.zeros((n,), jnp.int32))
            return ("num", jnp.zeros((n,), jnp.float32))
        consts = {"Pi": math.pi, "E": math.e,
                  "Eps": 1.1920928955078125e-07,
                  "NumMax": 3.4028234663852886e38,
                  "NumMin": 1.1754943508222875e-38,
                  "Inf": float("inf")}
        if name in consts:
            return ("num", jnp.float32(consts[name]))
        # scene parameters (docs/src/scene/pexpr.rst "Scene Parameters").
        # When the compiled params vector is available the lookup is a
        # TRACED slice (registry values change without recompilation,
        # Runtime.cpp:668-686 / registry.art get_global_parameter_*);
        # otherwise fall back to the compile-time constant.
        reg = getattr(self.scene, "param_registry", None)
        tbl = self.tables if isinstance(self.tables, dict) else None
        if reg and name in reg and tbl is not None and "params" in tbl:
            kind, off, size = reg[name]
            vec = tbl["params"][off:off + size]
            if kind == "num":
                return ("num", vec[0])
            if kind == "int":
                return ("int", vec[0].astype(jnp.int32))
            return (kind, vec)
        params = getattr(self.scene, "parameter_values", {}) or {}
        if name in params:
            kind, val = params[name]
            return (kind, jnp.asarray(val, jnp.float32))
        # textures as variables: sampled at the implicit uv
        tex_id = self._tex_id(name)
        if tex_id is not None:
            return self._sample_tex(tex_id, ("vec2", self.ctx["uv"]))
        raise PExprError(f"Unknown PExpr variable '{name}'")

    def _tex_id(self, name):
        for i, t in enumerate(self.scene.textures):
            if t["name"] == name:
                return i
        return None

    def _sample_tex(self, tex_id, uv):
        from ignis_jax.texture.eval import eval_one
        rgb = eval_one(self.scene, self.tables, self.scene.textures[tex_id],
                       uv[1], self.ctx)
        alpha = jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)
        return ("vec4", jnp.concatenate([rgb, alpha], axis=-1))

    # ---- dispatch
    def eval(self, node):
        if node.op == "num":
            return ("num", jnp.float32(node.value))
        if node.op == "int":
            return ("int", jnp.int32(node.value))
        if node.op == "bool":
            return ("bool", jnp.asarray(node.value))
        if node.op == "str":
            return ("str", node.value)
        if node.op == "var":
            return self.var(node.value)
        if node.op == "neg":
            k, a = self.eval(node.args[0])
            return (k, -a)
        if node.op == "not":
            k, a = self.eval(node.args[0])
            return ("bool", ~a)
        if node.op == "swizzle":
            return self.swizzle(self.eval(node.args[0]), node.value)
        if node.op == "bin":
            return self.binary(node.value, self.eval(node.args[0]),
                               self.eval(node.args[1]))
        if node.op == "call":
            return self.call(node.value, [self.eval(a) for a in node.args])
        raise PExprError(f"Bad node {node.op}")

    def swizzle(self, v, members):
        k, a = v
        if k == "num":
            a = a[..., None]
            comps = [0] * len(members)
            idx = [0 for _ in members]
        elif k in ("vec2", "vec3", "vec4"):
            idx = []
            for ch in members:
                if ch not in _SWIZ:
                    raise PExprError(f"Bad swizzle '{members}'")
                idx.append(_SWIZ[ch])
        else:
            raise PExprError(f"Cannot swizzle {k}")
        out = a[..., idx]
        n = len(idx)
        if n == 1:
            return ("num", out[..., 0])
        return (f"vec{n}", out)

    def binary(self, op, a, b):
        if op in ("&&", "||"):
            fa, fb = a[1], b[1]
            return ("bool", fa & fb if op == "&&" else fa | fb)
        if op in ("==", "!=", "<", "<=", ">", ">="):
            aa, bb, k = _broadcast_pair(a, b)
            va, vb = aa[1], bb[1]
            r = {"==": va == vb, "!=": va != vb, "<": va < vb,
                 "<=": va <= vb, ">": va > vb, ">=": va >= vb}[op]
            if r.ndim and k in ("vec2", "vec3", "vec4"):
                r = jnp.all(r, axis=-1)
            return ("bool", r)
        aa, bb, k = _broadcast_pair(a, b)
        va, vb = aa[1], bb[1]
        if op == "+":
            return (k, va + vb)
        if op == "-":
            return (k, va - vb)
        if op == "*":
            return (k, va * vb)
        if op == "/":
            if k == "int":
                return (k, va // vb)
            return (k, va / vb)
        if op == "%":
            return (k, va % vb)
        if op == "^":
            return (k if k != "int" else "num",
                    jnp.power(va.astype(jnp.float32), vb.astype(jnp.float32)))
        raise PExprError(f"Bad operator {op}")

    # ---- functions
    def call(self, name, args):
        tex_id = self._tex_id(name)
        if tex_id is not None and len(args) == 1 and args[0][0] == "vec2":
            return self._sample_tex(tex_id, args[0])
        if name == "check_ray_flag":
            # Transpiler.cpp:78-101 → check_ray_visibility(ctx.ray, flag).
            # Lane ray flags ride in ctx["ray_flags"]; contexts that never
            # set them are primary-shading contexts (camera rays).
            bit = {"camera": 1, "light": 2, "bounce": 4, "shadow": 8}.get(
                str(args[0][1]).lower() if args[0][0] == "str" else "", 0)
            rf = self.ctx.get("ray_flags")
            if rf is None:
                n = self.ctx["uv"].shape[0]
                rf = jnp.full((n,), 1, jnp.int32)
            return ("bool", (rf & bit) != 0)
        f = _FUNCTIONS.get(name)
        if f is None:
            raise PExprError(f"Unknown PExpr function '{name}'")
        return f(args)


def _vecn(args, n):
    vals = [_as_num(a)[1] if a[0] == "int" else a[1] for a in args]
    if len(vals) == 1:
        v = jnp.broadcast_to(vals[0][..., None], vals[0].shape + (n,)) \
            if hasattr(vals[0], "shape") else jnp.full((n,), vals[0])
        return (f"vec{n}", v)
    vb = jnp.broadcast_arrays(*vals)
    return (f"vec{n}", jnp.stack(vb, axis=-1))


def _color_fn(args):
    if len(args) == 3:
        r = _vecn(args, 3)
        ones = jnp.ones(r[1].shape[:-1] + (1,), jnp.float32)
        return ("vec4", jnp.concatenate([r[1], ones], axis=-1))
    return _vecn(args, 4)


def _reduce_fn(fn):
    def wrap(args):
        k, a = args[0]
        return ("num", fn(a))
    return wrap


def _mix(args):
    a, b, t = args
    k = a[0]
    tv = _as_num(t)[1]
    if k in ("vec2", "vec3", "vec4"):
        tv = tv[..., None]
    return (k, a[1] * (1 - tv) + b[1] * tv)


def _select(args):
    c, a, b = args
    cv = c[1]
    if a[0] in ("vec2", "vec3", "vec4") and cv.ndim:
        cv = cv[..., None]
    return (a[0], jnp.where(cv, a[1], b[1]))


def _clamp(args):
    v, lo, hi = args
    return (v[0], jnp.clip(v[1], lo[1], hi[1]))


def _noise_fn(args):
    from ignis_jax.texture.eval import _noise2
    v = args[0]
    seed = int(0)
    if v[0] in ("num", "int"):
        p = jnp.stack([_as_num(v)[1], jnp.zeros_like(_as_num(v)[1])], axis=-1)
    elif v[0] == "vec2":
        p = v[1]
    else:
        p = v[1][..., :2]
    return ("num", _noise2(p, seed))


def _checkerboard_fn(args):
    v = args[0][1]
    px = (jnp.floor(v[..., 0] % 2.0)).astype(jnp.int32) % 2
    py = (jnp.floor(v[..., 1] % 2.0)).astype(jnp.int32) % 2
    return ("int", jnp.where(px == py, jnp.int32(1), jnp.int32(0)))


def _dot_fn(args):
    return ("num", jnp.sum(args[0][1] * args[1][1], axis=-1))


def _cross_fn(args):
    return ("vec3", jnp.cross(args[0][1], args[1][1]))


def _norm_fn(args):
    k, a = args[0]
    l = jnp.sqrt(jnp.sum(a * a, axis=-1, keepdims=True))
    return (k, a / jnp.maximum(l, 1e-20))


def _length_fn(args):
    return ("num", jnp.sqrt(jnp.sum(args[0][1] ** 2, axis=-1)))


def _fresnel_dielectric_fn(args):
    from ignis_jax.bsdf.union import _fresnel_dielectric
    return ("num", _fresnel_dielectric(_as_num(args[0])[1], _as_num(args[1])[1]))


def _smoothstep(args):
    x = jnp.clip(_as_num(args[0])[1], 0.0, 1.0)
    return ("num", x * x * (3.0 - 2.0 * x))


def _luminance(args):
    a = args[0][1]
    return ("num", a[..., 0] * 0.2126 + a[..., 1] * 0.7152 + a[..., 2] * 0.0722)


def _blackbody(args):
    """math.art blackbody: sRGB/D65 fit, valid [1000, 20000] K."""
    t2 = jnp.clip(_as_num(args[0])[1], 1000.0, 20000.0)
    # low segment [1000, 6500]
    tl = (t2 - 1000.0) / 5500.0
    r_l = jnp.exp(-6.43983699 * tl + 0.75651596) + (
        (0.79760204 * tl - 2.04782763) * tl + 2.33744911)
    b_l = jnp.maximum(0.0, jnp.exp(0.24888616 * tl + 1.39095510) - 4.17216437)
    g_l = (1.0 - r_l * 0.2126 - b_l * 0.0722) / 0.7152
    # high segment [6500, 20000]
    th = (t2 - 6500.0) / 13500.0
    r_h = jnp.exp(-5.08603402 * th - 1.68935495) + (
        (0.07954146 * th - 0.23566459) * th + 0.85280697)
    b_h = ((th - 2.25659290) * th + 2.11298599) * th + 1.02683036
    g_h = (1.0 - r_h * 0.2126 - b_h * 0.0722) / 0.7152
    lo = t2 <= 6500.0
    rgb = jnp.stack([jnp.where(lo, r_l, r_h), jnp.where(lo, g_l, g_h),
                     jnp.where(lo, b_l, b_h)], axis=-1)
    a = jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)
    return ("vec4", jnp.concatenate([jnp.maximum(rgb, 0.0), a], axis=-1))


def _rgb_to_hsv(c):
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    d = mx - mn
    e = 1e-10
    h = jnp.where(
        mx == r, (g - b) / (d + e) % 6.0,
        jnp.where(mx == g, (b - r) / (d + e) + 2.0, (r - g) / (d + e) + 4.0))
    h = (h / 6.0) % 1.0
    s = d / (mx + e)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    """color.art hsv_to_srgb (iq-style palette formulation)."""
    k = jnp.stack([(h + 1.0) % 1.0 * 6.0, (h + 2.0 / 3.0) % 1.0 * 6.0,
                   (h + 1.0 / 3.0) % 1.0 * 6.0], axis=-1)
    p = jnp.abs(k - 3.0)
    core = jnp.clip(p - 1.0, 0.0, 1.0)
    return v[..., None] * (1.0 + s[..., None] * (core - 1.0))


def _color_conv(fn):
    def wrap(args):
        c = args[0][1]
        rgb = fn(c[..., :3])
        return ("vec4", jnp.concatenate([rgb, c[..., 3:4]], axis=-1))
    return wrap


def _conv_hsv(c):
    h, s, v = _rgb_to_hsv(c)
    return jnp.stack([h, s, v], axis=-1)


def _conv_from_hsv(c):
    return _hsv_to_rgb(c[..., 0], c[..., 1], c[..., 2])


def _conv_hsl(c):
    h, s, v = _rgb_to_hsv(c)
    l = v * (1.0 - s / 2.0)
    denom = jnp.minimum(l, 1.0 - l)
    sl = jnp.where(denom <= 1e-10, 0.0, (v - l) / jnp.maximum(denom, 1e-10))
    return jnp.stack([h, sl, l], axis=-1)


def _conv_from_hsl(c):
    h, s, l = c[..., 0], c[..., 1], c[..., 2]
    v = l + s * jnp.minimum(l, 1.0 - l)
    sv = jnp.where(v <= 1e-10, 0.0, 2.0 * (1.0 - l / jnp.maximum(v, 1e-10)))
    return _hsv_to_rgb(h, sv, v)


# sRGB (linear) <-> XYZ, D65 (color.art srgb_to_xyz/xyz_to_srgb)
_RGB2XYZ = np.float32([[0.4124564, 0.3575761, 0.1804375],
                       [0.2126729, 0.7151522, 0.0721750],
                       [0.0193339, 0.1191920, 0.9503041]])
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)


def _lerp_c(a, b, t):
    return a * (1.0 - t) + b * t


def _mix_mode(fn):
    """Blend-mode mixes (color.art:209-266): rgb blended, alpha from a."""
    def wrap(args):
        a = args[0][1]
        b = args[1][1]
        t = _as_num(args[2])[1][..., None]
        rgb = fn(a[..., :3], b[..., :3], t)
        return ("vec4", jnp.concatenate([rgb, a[..., 3:4]], axis=-1))
    return wrap


def _mix_screen_rgb(a, b, t):
    return 1.0 - (_lerp_c(jnp.ones_like(b), 1.0 - b, t)) * (1.0 - a)


def _mix_overlay_rgb(a, b, t):
    return jnp.where(a < 0.5, a * _lerp_c(1.0, 2.0 * b, t),
                     1.0 - (1.0 - a) * _lerp_c(1.0, 2.0 * (1.0 - b), t))


def _mix_dodge_rgb(a, b, t):
    den = 1.0 - t * b
    d = jnp.minimum(1.0, jnp.where(den == 0.0, 0.0, a / jnp.where(den == 0.0, 1.0, den)))
    return jnp.where(a == 0.0, a, jnp.where(d < 0.0, 1.0, d))


def _mix_burn_rgb(a, b, t):
    d = _lerp_c(jnp.ones_like(b), b, t)
    return jnp.where(d <= 1.1920929e-07, 0.0,
                     jnp.clip(1.0 - (1.0 - a) / jnp.where(d == 0.0, 1.0, d),
                              0.0, 1.0))


def _mix_soft_rgb(a, b, t):
    scr = 1.0 - (1.0 - a) * (1.0 - b)
    return _lerp_c(a, (1.0 - a) * a * b + a * scr, t)


def _mix_linear_rgb(a, b, t):
    return a + jnp.where(b > 0.5, 2.0 * (b - 0.5), 2.0 * b - 1.0) * t


def _fresnel_conductor_fn(args):
    from ignis_jax.bsdf.union import _conductor_factor
    n = _as_num(args[0])[1]
    k = _as_num(args[1])[1]
    ci = _as_num(args[2])[1]
    return ("num", _conductor_factor(n, k, ci))


def _angle_fn(args):
    a, b = args[0][1], args[1][1]
    la = jnp.sqrt(jnp.sum(a * a, axis=-1))
    lb = jnp.sqrt(jnp.sum(b * b, axis=-1))
    cosv = jnp.sum(a * b, axis=-1) / jnp.maximum(la * lb, 1e-20)
    return ("num", jnp.arccos(jnp.clip(cosv, -1.0, 1.0)))


def _euler_mat(e):
    cx, cy, cz = jnp.cos(e[..., 0]), jnp.cos(e[..., 1]), jnp.cos(e[..., 2])
    sx, sy, sz = jnp.sin(e[..., 0]), jnp.sin(e[..., 1]), jnp.sin(e[..., 2])
    # rows of euler_to_mat3x3 (vector.art:195-214, column-major make_mat3x3)
    r0 = jnp.stack([cy * cz, sy * sx * cz - cx * sz, sy * cx * cz + sx * sz], -1)
    r1 = jnp.stack([cy * sz, sy * sx * sz + cx * cz, sy * cx * sz - sx * cz], -1)
    r2 = jnp.stack([-sy, cy * sx, cy * cx], -1)
    return jnp.stack([r0, r1, r2], axis=-2)


def _rotate_euler(args, inverse=False):
    p, e = args[0][1], args[1][1]
    m = _euler_mat(e)
    if inverse:
        out = jnp.einsum("...ji,...j->...i", m, p, precision=HIGHEST)
    else:
        out = jnp.einsum("...ij,...j->...i", m, p, precision=HIGHEST)
    return ("vec3", out)


def _rotate_axis_fn(args):
    p = args[0][1]
    ang = _as_num(args[1])[1]
    ax = args[2][1]
    c = jnp.cos(ang)[..., None]
    s = jnp.sin(ang)[..., None]
    d = jnp.sum(ax * p, axis=-1, keepdims=True)
    return ("vec3", p * c + jnp.cross(ax, p) * s + ax * d * (1.0 - c))


def _hash_fn(args):
    """hash_rndf (random.art:91): FNV-seeded TEA draw from the f32 bits."""
    from ignis_jax.core import rng
    x = _as_num(args[0])[1]
    bits = jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32),
                                        jnp.uint32)
    seed = rng.hash_combine(rng.hash_init(), bits)
    v, _ = rng.next_f32(seed, jnp.ones_like(bits))
    return ("num", v)




def _colored_noise(scalar_fn):
    """cnoise family (noise.art:8,266): 3 offset-seed scalar evaluations."""
    def wrap(args):
        r = scalar_fn([args[0]])[1]
        g = scalar_fn([(args[0][0], args[0][1] + 17.31)])[1]
        b = scalar_fn([(args[0][0], args[0][1] + 41.97)])[1]
        rgb = jnp.stack([r, g, b], axis=-1)
        a = jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)
        return ("vec4", jnp.concatenate([rgb, a], axis=-1))
    return wrap


def _lookup_fn(args):
    """Curve lookup (Transpiler.cpp:206-247 → math.art lookup_curve).

    lookup(interp: str, extrapolate: bool, t: num, p0: vec2, ...)."""
    interp = str(args[0][1]).lower() if args[0][0] == "str" else "linear"
    linear = interp != "constant"
    extrap = args[1][1]
    t = _as_num(args[2])[1]
    xs = [a[1][..., 0] for a in args[3:]]
    ys = [a[1][..., 1] for a in args[3:]]
    count = len(xs)
    if count == 0:
        return ("num", jnp.zeros_like(t))
    x = jnp.stack([jnp.broadcast_to(v, t.shape) for v in xs], axis=-1)
    y = jnp.stack([jnp.broadcast_to(v, t.shape) for v in ys], axis=-1)
    i = jnp.clip(jnp.sum((x <= t[..., None]).astype(jnp.int32), axis=-1) - 1,
                 0, count - 1)
    ii = jnp.minimum(i + 1, count - 1)
    lanes = jnp.arange(t.shape[0]) if t.ndim else 0
    x0 = x[..., i] if t.ndim == 0 else x[lanes, i]
    x1 = x[..., ii] if t.ndim == 0 else x[lanes, ii]
    y0 = y[..., i] if t.ndim == 0 else y[lanes, i]
    y1 = y[..., ii] if t.ndim == 0 else y[lanes, ii]
    if linear:
        t0 = jnp.clip((t - x0) / jnp.maximum(x1 - x0, 1e-10), 0.0, 1.0)
        inside = y0 + (y1 - y0) * t0
    else:
        inside = y0
    # out-of-range handling (math.art lookup_curve)
    yl0 = y[..., 0] if t.ndim == 0 else y[lanes, 0]
    yl1 = y[..., 1 % count] if t.ndim == 0 else y[lanes, 1 % count]
    ye0 = y[..., count - 1] if t.ndim == 0 else y[lanes, count - 1]
    ye1 = y[..., max(count - 2, 0)] if t.ndim == 0 else y[lanes, max(count - 2, 0)]
    lo_ex = yl0 + (yl0 - yl1) * (-t) * (count - 1)
    hi_ex = ye0 + (ye0 - ye1) * (t - 1.0) * (count - 1)
    lo = jnp.where(extrap, lo_ex, yl0)
    hi = jnp.where(extrap, hi_ex, ye0)
    out = jnp.where(t < 0.0, lo, jnp.where(t > 1.0, hi, inside))
    return ("num", out)


def _bump_fn(args):
    """node_bump (texture/bump.art:3-11; Mikkelsen, 'Bump Mapping
    Unparameterized Surfaces on the GPU', 2010):
    bump(input, Nx, Ny, distance, sample_dx, sample_dy)."""
    inp, nx, ny = args[0][1], args[1][1], args[2][1]
    distance = _as_num(args[3])[1]
    sdx = _as_num(args[4])[1]
    sdy = _as_num(args[5])[1]
    rx = jnp.cross(ny, inp)
    ry = jnp.cross(inp, nx)
    det = jnp.sum(nx * rx, axis=-1)
    grad = rx * sdx[..., None] + ry * sdy[..., None]
    out = (inp * jnp.abs(det)[..., None]
           - grad * (jnp.sign(det) * distance)[..., None])
    norm = jnp.sqrt(jnp.maximum(jnp.sum(out * out, axis=-1,
                                        keepdims=True), 1e-20))
    return ("vec3", out / norm)


def _ensure_valid_reflection(args):
    """Cycles' shading-normal clamp (sampling.art:120-160)."""
    ng, i, n = args[0][1], args[1][1], args[2][1]
    r = 2.0 * jnp.sum(i * n, axis=-1, keepdims=True) * n - i
    thr = jnp.minimum(0.9 * jnp.sum(ng * i, axis=-1), 0.01)
    ok = jnp.sum(ng * r, axis=-1) >= thr
    ndotng = jnp.sum(n * ng, axis=-1, keepdims=True)
    xraw = n - ng * ndotng
    x = xraw / jnp.maximum(
        jnp.sqrt(jnp.sum(xraw * xraw, axis=-1, keepdims=True)), 1e-20)
    ix = jnp.sum(i * x, axis=-1)
    iz = jnp.sum(i * ng, axis=-1)
    ix2, iz2 = ix * ix, iz * iz
    a = ix2 + iz2
    b = jnp.sqrt(jnp.maximum(ix2 * (a - thr * thr), 0.0))
    c = iz * thr + a
    fac = 0.5 / jnp.maximum(a, 1e-20)
    n1z2 = fac * (b + c)
    n2z2 = fac * (-b + c)
    v1 = (n1z2 > 1e-5) & (n1z2 <= 1.0 + 1e-5)
    v2 = (n2z2 > 1e-5) & (n2z2 <= 1.0 + 1e-5)
    # both valid -> pick the one closer to N (larger z); else the valid one
    z2 = jnp.where(v1 & v2, jnp.maximum(n1z2, n2z2),
                   jnp.where(v1, n1z2, n2z2))
    nx = jnp.sqrt(jnp.maximum(1.0 - z2, 0.0))
    nz = jnp.sqrt(jnp.maximum(z2, 0.0))
    n_new = x * nx[..., None] + ng * nz[..., None]
    use_new = (~ok) & (v1 | v2)
    out = jnp.where(use_new[..., None], n_new,
                    jnp.where(ok[..., None], n, ng))
    return ("vec3", out)


_FUNCTIONS = {
    # elementwise math family (Transpiler.cpp _MF1A table)
    **{name: _elemwise(fn) for name, fn in {
        "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
        "asin": jnp.arcsin, "acos": jnp.arccos, "atan": jnp.arctan,
        "exp": jnp.exp, "exp2": jnp.exp2, "log": jnp.log, "log2": jnp.log2,
        "log10": jnp.log10, "floor": jnp.floor, "ceil": jnp.ceil,
        "round": jnp.round, "fract": lambda x: x - jnp.floor(x),
        "trunc": jnp.trunc, "sqrt": jnp.sqrt, "cbrt": jnp.cbrt,
        "abs": jnp.abs, "sign": jnp.sign,
        "rad": jnp.deg2rad, "deg": jnp.rad2deg,
    }.items()},
    **{name: _elemwise2(fn) for name, fn in {
        "atan2": jnp.arctan2, "min": jnp.minimum, "max": jnp.maximum,
        "fmod": jnp.fmod, "pow": jnp.power,
        "snap": lambda a, b: jnp.floor(jnp.where(b == 0, 0.0, a / jnp.where(b == 0, 1.0, b))) * b,
        # pingpong (math.art:94; guard uses eps — the reference compares
        # |y| <= flt_pi there, which zeroes every |y| <= 3.14 and cannot be
        # the intended Blender semantics, so we deviate to the eps guard)
        "pingpong": lambda x, y: jnp.where(
            jnp.abs(y) <= 1.1920929e-07,
            0.0, jnp.abs(((x - y) / jnp.where(y == 0, 1.0, y * 2)
                          - jnp.floor((x - y) / jnp.where(y == 0, 1.0, y * 2)))
                         * y * 2 - y)),
    }.items()},
    "vec2": lambda args: _vecn(args, 2),
    "vec3": lambda args: _vecn(args, 3),
    "vec4": lambda args: _vecn(args, 4),
    "color": _color_fn,
    "mix": _mix, "select": _select, "clamp": _clamp,
    "dot": _dot_fn, "cross": _cross_fn, "norm": _norm_fn,
    "length": _length_fn,
    "sum": _reduce_fn(lambda a: jnp.sum(a, axis=-1)),
    "avg": _reduce_fn(lambda a: jnp.mean(a, axis=-1)),
    "luminance": _luminance,
    "noise": _noise_fn, "snoise": _noise_fn, "pnoise": _noise_fn,
    "cellnoise": _noise_fn, "perlin": _noise_fn, "sperlin": _noise_fn,
    "voronoi": _noise_fn, "fbm": _noise_fn,
    "checkerboard": _checkerboard_fn,
    "fresnel_dielectric": _fresnel_dielectric_fn,
    "fresnel_conductor": _fresnel_conductor_fn,
    "blackbody": _blackbody,
    "rgbtoxyz": _color_conv(lambda c: jnp.einsum(
        "ij,...j->...i", jnp.asarray(_RGB2XYZ), c, precision=HIGHEST)),
    "xyztorgb": _color_conv(lambda c: jnp.einsum(
        "ij,...j->...i", jnp.asarray(_XYZ2RGB), c, precision=HIGHEST)),
    "rgbtohsv": _color_conv(_conv_hsv),
    "hsvtorgb": _color_conv(_conv_from_hsv),
    "rgbtohsl": _color_conv(_conv_hsl),
    "hsltorgb": _color_conv(_conv_from_hsl),
    "mix_screen": _mix_mode(_mix_screen_rgb),
    "mix_overlay": _mix_mode(_mix_overlay_rgb),
    "mix_dodge": _mix_mode(_mix_dodge_rgb),
    "mix_burn": _mix_mode(_mix_burn_rgb),
    "mix_soft": _mix_mode(_mix_soft_rgb),
    "mix_linear": _mix_mode(_mix_linear_rgb),
    "mix_hue": _mix_mode(lambda a, b, t: _lerp_c(
        a, _conv_from_hsv(jnp.concatenate(
            [_conv_hsv(b)[..., 0:1], _conv_hsv(a)[..., 1:3]], axis=-1)), t)),
    "mix_saturation": _mix_mode(lambda a, b, t: _conv_from_hsv(
        jnp.concatenate([_conv_hsv(a)[..., 0:1],
                         _lerp_c(_conv_hsv(a)[..., 1:2],
                                 _conv_hsv(b)[..., 1:2], t),
                         _conv_hsv(a)[..., 2:3]], axis=-1))),
    "mix_value": _mix_mode(lambda a, b, t: _conv_from_hsv(
        jnp.concatenate([_conv_hsv(a)[..., 0:2],
                         _lerp_c(_conv_hsv(a)[..., 2:3],
                                 _conv_hsv(b)[..., 2:3], t)], axis=-1))),
    "mix_color": _mix_mode(lambda a, b, t: _lerp_c(
        a, _conv_from_hsv(jnp.concatenate(
            [_conv_hsv(b)[..., 0:2], _conv_hsv(a)[..., 2:3]], axis=-1)), t)),
    "angle": _angle_fn,
    "rotate_euler": lambda args: _rotate_euler(args),
    "rotate_euler_inverse": lambda args: _rotate_euler(args, inverse=True),
    "rotate_axis": _rotate_axis_fn,
    "hash": _hash_fn,
    "signbit": lambda args: ("bool", _as_num(args[0])[1] < 0),
    "lookup": _lookup_fn,
    "ensure_valid_reflection": _ensure_valid_reflection,
    "bump": _bump_fn,
    "lerp": _mix,
    "smin": lambda args: ("num", (lambda x, y, k: jnp.minimum(x, y)
                                  - (lambda h: h * h * h * k / 6.0)(
        jnp.maximum(k - jnp.abs(x - y), 0.0) / jnp.maximum(k, 1e-20)))(
        _as_num(args[0])[1], _as_num(args[1])[1], _as_num(args[2])[1])),
    "smax": lambda args: ("num", -(lambda x, y, k: jnp.minimum(x, y)
                                   - (lambda h: h * h * h * k / 6.0)(
        jnp.maximum(k - jnp.abs(x - y), 0.0) / jnp.maximum(k, 1e-20)))(
        -_as_num(args[0])[1], -_as_num(args[1])[1], _as_num(args[2])[1])),
    "wrap": lambda args: ("num", (lambda v, lo, hi: jnp.where(
        hi - lo <= 1.1920929e-07, lo,
        v - (hi - lo) * jnp.floor((v - lo) / jnp.where(
            hi == lo, 1.0, hi - lo))))(
        _as_num(args[0])[1], _as_num(args[1])[1], _as_num(args[2])[1])),
    "smoothstep": _smoothstep,
    "smootherstep": lambda args: ("num", (lambda x: x ** 3 * (x * (6 * x - 15) + 10))(jnp.clip(_as_num(args[0])[1], 0, 1))),
    "dist": lambda args: ("num", jnp.sqrt(jnp.sum((args[0][1] - args[1][1]) ** 2, axis=-1))),
    "reflect": lambda args: ("vec3", 2.0 * jnp.sum(args[1][1] * args[0][1], axis=-1, keepdims=True) * args[1][1] - args[0][1]),
}


# colored noise family (noise.art:235-266): three offset-seed scalar draws;
# our scalar noise is already an (allowed) re-design, so the colored
# variants inherit it rather than matching the reference pattern bit-exactly
for _cname, _sname in (("cnoise", "noise"), ("cpnoise", "pnoise"),
                       ("ccellnoise", "cellnoise"), ("cperlin", "perlin"),
                       ("cvoronoi", "voronoi"), ("cfbm", "fbm")):
    _FUNCTIONS[_cname] = _colored_noise(_FUNCTIONS[_sname])


_PARSE_CACHE: dict[str, Node] = {}


def eval_pexpr(scene, tables, src: str, ctx):
    """Evaluate a PExpr string over the lane context; returns (kind, array)."""
    node = _PARSE_CACHE.get(src)
    if node is None:
        node = parse_pexpr(src)
        _PARSE_CACHE[src] = node
    return Evaluator(scene, tables, ctx).eval(node)


def eval_pexpr_color(scene, tables, src: str, uv, ctx=None):
    """Evaluate to an RGB color (N, 3) — vec4 drops alpha, num broadcasts."""
    full_ctx = dict(ctx or {})
    full_ctx.setdefault("uv", uv)
    kind, val = eval_pexpr(scene, tables, src, full_ctx)
    if kind == "num" or kind == "int":
        v = jnp.asarray(val, jnp.float32)
        return jnp.broadcast_to(v[..., None], v.shape + (3,)) if v.ndim else \
            jnp.broadcast_to(v, uv.shape[:-1] + (3,))
    if kind == "vec4":
        return val[..., :3]
    if kind == "vec3":
        return val
    if kind == "vec2":
        return jnp.concatenate([val, jnp.zeros(val.shape[:-1] + (1,), jnp.float32)], axis=-1)
    raise PExprError(f"Cannot interpret PExpr result of type {kind} as color")
