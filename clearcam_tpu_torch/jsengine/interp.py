"""Tree-walking interpreter for the jsengine AST (clean-room, Python).

Value model:
- numbers  -> Python float (ToInt32 for bit ops; NaN via float('nan'))
- strings  -> Python str; booleans -> Python bool
- null     -> NULL singleton; undefined -> UNDEF singleton
- arrays   -> JSArray (wraps a Python list)
- objects  -> JSObject (insertion-ordered dict)
- functions-> JSFunction (closure) or any Python callable (host function)
- promises -> JSPromise, *eagerly resolved*: every async source in the fake
  browser (fetch, play(), FileReader) computes synchronously, so ``await``
  just unwraps. setTimeout/setInterval callbacks are queued for the harness.

Host objects participate via duck typing: anything with ``js_get``/
``js_set`` methods is property-addressable from JS (the fake DOM uses
this); plain Python callables are callable from JS.
"""

from __future__ import annotations

import json as _json
import math

from .es import parse, JSSyntaxError  # noqa: F401 (re-export for harnesses)


class _Undefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


class _Null:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "null"

    def __bool__(self):
        return False


UNDEF = _Undefined()
NULL = _Null()
NAN = float("nan")
_CHAIN = object()  # optional-chaining short-circuit sentinel


class JSObject:
    def __init__(self, props=None):
        self.props = dict(props or {})

    def js_get(self, name):
        return self.props.get(name, UNDEF)

    def js_set(self, name, value):
        self.props[name] = value

    def __repr__(self):  # pragma: no cover
        return f"JSObject({self.props!r})"


class JSArray:
    def __init__(self, items=None):
        self.items = list(items or [])

    def __repr__(self):  # pragma: no cover
        return f"JSArray({self.items!r})"


class JSFunction:
    def __init__(self, name, params, body, env, is_arrow, is_async, this_val=UNDEF):
        self.name = name or ""
        self.params = params
        self.body = body
        self.env = env
        self.is_arrow = is_arrow
        self.is_async = is_async
        self.this_val = this_val  # lexical this for arrows


class JSPromise:
    """Eagerly settled promise: value or error is known at construction."""

    def __init__(self, value=UNDEF, error=None):
        self.value = value
        self.error = error  # a JSThrow or None


class JSThrow(Exception):
    def __init__(self, value):
        self.value = value
        msg = js_str(value)
        if isinstance(value, JSObject) and "message" in value.props:
            msg = js_str(value.props.get("name", "Error")) + ": " + \
                js_str(value.props["message"])
        super().__init__(msg)


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


def throw_error(msg):
    raise JSThrow(JSObject({"name": "Error", "message": msg}))


def _fit_args(fn, args):
    """Trim JS varargs (e.g. map passes (v, i, arr)) to what a host callable
    accepts; callables with *args receive everything."""
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return args
    maxn = 0
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL,):
            return args
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            maxn += 1
    return args[:maxn]


# --------------------------------------------------------------------------
# coercions
# --------------------------------------------------------------------------

def truthy(v) -> bool:
    if v is UNDEF or v is NULL:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return v != 0 and not math.isnan(v)
    if isinstance(v, str):
        return v != ""
    return True  # objects/arrays/functions


def js_num(v) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if isinstance(v, int):
        return float(v)
    if v is NULL:
        return 0.0
    if v is UNDEF:
        return NAN
    if isinstance(v, str):
        s = v.strip()
        if s == "":
            return 0.0
        try:
            if s.lower().startswith("0x"):
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return NAN
    if isinstance(v, JSArray):
        if not v.items:
            return 0.0
        if len(v.items) == 1:
            return js_num(v.items[0])
        return NAN
    return NAN


def js_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return _fmt_num(v)
    if isinstance(v, int):
        return _fmt_num(float(v))
    if isinstance(v, str):
        return v
    if v is UNDEF:
        return "undefined"
    if v is NULL:
        return "null"
    if isinstance(v, JSArray):
        return ",".join("" if x is UNDEF or x is NULL else js_str(x) for x in v.items)
    if isinstance(v, JSFunction):
        return f"function {v.name}() {{ ... }}"
    if isinstance(v, JSObject):
        return "[object Object]"
    if hasattr(v, "js_str"):
        return v.js_str()
    if callable(v):
        return "function () { [native code] }"
    return str(v)


def _fmt_num(f: float) -> str:
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "Infinity" if f > 0 else "-Infinity"
    if f == int(f) and abs(f) < 1e21:
        return str(int(f))
    return repr(f)


def to_int32(v) -> int:
    f = js_num(v)
    if math.isnan(f) or math.isinf(f):
        return 0
    i = int(f) & 0xFFFFFFFF
    return i - 0x100000000 if i >= 0x80000000 else i


def strict_eq(a, b) -> bool:
    if a is UNDEF and b is UNDEF:
        return True
    if a is NULL and b is NULL:
        return True
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        fa, fb = float(a), float(b)
        return (not math.isnan(fa)) and (not math.isnan(fb)) and fa == fb
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b


def loose_eq(a, b) -> bool:
    if (a is UNDEF or a is NULL) and (b is UNDEF or b is NULL):
        return True
    if (a is UNDEF or a is NULL) != (b is UNDEF or b is NULL):
        return False
    if isinstance(a, str) and isinstance(b, (int, float)) and not isinstance(b, bool):
        return strict_eq(js_num(a), float(b))
    if isinstance(b, str) and isinstance(a, (int, float)) and not isinstance(a, bool):
        return strict_eq(float(a), js_num(b))
    if isinstance(a, bool):
        return loose_eq(js_num(a), b)
    if isinstance(b, bool):
        return loose_eq(a, js_num(b))
    return strict_eq(a, b)


def js_iter(v):
    """Iterable protocol for for-of / spread."""
    if isinstance(v, JSArray):
        return list(v.items)
    if isinstance(v, str):
        return list(v)
    if isinstance(v, list):
        return list(v)
    if hasattr(v, "js_iter"):
        return list(v.js_iter())
    throw_error(f"{js_str(v)} is not iterable")


# --------------------------------------------------------------------------
# property access on primitives / built-in containers
# --------------------------------------------------------------------------

def _sort_key_default(x):
    return js_str(x)


def _array_methods(arr: JSArray, name, interp):
    items = arr.items

    def push(*vs):
        items.extend(vs)
        return float(len(items))

    def pop():
        return items.pop() if items else UNDEF

    def shift():
        return items.pop(0) if items else UNDEF

    def unshift(*vs):
        items[:0] = vs
        return float(len(items))

    def _norm(idx, default):
        if idx is UNDEF:
            return default
        i = int(js_num(idx))
        return max(0, len(items) + i) if i < 0 else min(i, len(items))

    def slice(start=UNDEF, end=UNDEF):
        return JSArray(items[_norm(start, 0):_norm(end, len(items))])

    def splice(start=UNDEF, count=UNDEF, *vs):
        s = _norm(start, 0)
        c = len(items) - s if count is UNDEF else max(0, int(js_num(count)))
        removed = items[s:s + c]
        items[s:s + c] = vs
        return JSArray(removed)

    def indexOf(x, *_):
        for i, it in enumerate(items):
            if strict_eq(it, x):
                return float(i)
        return -1.0

    def includes(x, *_):
        return any(strict_eq(it, x) for it in items)

    def join(sep=UNDEF):
        s = "," if sep is UNDEF else js_str(sep)
        return s.join("" if x is UNDEF or x is NULL else js_str(x) for x in items)

    def _call(f, *args):
        return interp.call(f, UNDEF, list(args))

    def map_(f, *_):
        return JSArray([_call(f, x, float(i), arr) for i, x in enumerate(items)])

    def forEach(f, *_):
        for i, x in enumerate(list(items)):
            _call(f, x, float(i), arr)
        return UNDEF

    def filter_(f, *_):
        return JSArray([x for i, x in enumerate(items) if truthy(_call(f, x, float(i), arr))])

    def find(f, *_):
        for i, x in enumerate(items):
            if truthy(_call(f, x, float(i), arr)):
                return x
        return UNDEF

    def findIndex(f, *_):
        for i, x in enumerate(items):
            if truthy(_call(f, x, float(i), arr)):
                return float(i)
        return -1.0

    def some(f, *_):
        return any(truthy(_call(f, x, float(i), arr)) for i, x in enumerate(items))

    def every(f, *_):
        return all(truthy(_call(f, x, float(i), arr)) for i, x in enumerate(items))

    def reduce(f, *init):
        it = list(items)
        if init:
            acc = init[0]
            start = 0
        else:
            if not it:
                throw_error("Reduce of empty array with no initial value")
            acc, start = it[0], 1
        for i in range(start, len(it)):
            acc = _call(f, acc, it[i], float(i), arr)
        return acc

    def concat(*vs):
        out = list(items)
        for v in vs:
            out.extend(v.items) if isinstance(v, JSArray) else out.append(v)
        return JSArray(out)

    def sort(cmp=UNDEF):
        if cmp is UNDEF:
            items.sort(key=_sort_key_default)
        else:
            import functools
            items.sort(key=functools.cmp_to_key(
                lambda a, b: (lambda r: -1 if r < 0 else (1 if r > 0 else 0))(js_num(_call(cmp, a, b)))))
        return arr

    def reverse():
        items.reverse()
        return arr

    def flat(depth=UNDEF):
        d = 1 if depth is UNDEF else int(js_num(depth))

        def go(lst, d):
            out = []
            for x in lst:
                if isinstance(x, JSArray) and d > 0:
                    out.extend(go(x.items, d - 1))
                else:
                    out.append(x)
            return out
        return JSArray(go(items, d))

    def keys():
        return JSArray([float(i) for i in range(len(items))])

    table = {
        "push": push, "pop": pop, "shift": shift, "unshift": unshift,
        "slice": slice, "splice": splice, "indexOf": indexOf,
        "includes": includes, "join": join, "map": map_, "forEach": forEach,
        "filter": filter_, "find": find, "findIndex": findIndex,
        "some": some, "every": every, "reduce": reduce, "concat": concat,
        "sort": sort, "reverse": reverse, "flat": flat, "keys": keys,
    }
    return table.get(name)


def _string_methods(s: str, name, interp):
    def _idx(i, default):
        if i is UNDEF:
            return default
        v = int(js_num(i))
        return max(0, len(s) + v) if v < 0 else min(v, len(s))

    def slice(a=UNDEF, b=UNDEF):
        return s[_idx(a, 0):_idx(b, len(s))]

    def substring(a=UNDEF, b=UNDEF):
        x = min(max(0, int(js_num(a)) if a is not UNDEF else 0), len(s))
        y = min(max(0, int(js_num(b)) if b is not UNDEF else len(s)), len(s))
        return s[min(x, y):max(x, y)]

    def split(sep=UNDEF, limit=UNDEF):
        if sep is UNDEF:
            return JSArray([s])
        sp = js_str(sep)
        parts = list(s) if sp == "" else s.split(sp)
        if limit is not UNDEF:
            parts = parts[:int(js_num(limit))]
        return JSArray(parts)

    def replace(pat, rep):
        if hasattr(pat, "js_regex"):  # JSRegExp host object
            return pat.js_replace(s, rep, interp)
        return s.replace(js_str(pat), js_str(rep), 1)

    def replaceAll(pat, rep):
        return s.replace(js_str(pat), js_str(rep))

    def padStart(n, fill=UNDEF):
        f = " " if fill is UNDEF else js_str(fill)
        n = int(js_num(n))
        if len(s) >= n or not f:
            return s
        pad = (f * n)[:n - len(s)]
        return pad + s

    def padEnd(n, fill=UNDEF):
        f = " " if fill is UNDEF else js_str(fill)
        n = int(js_num(n))
        if len(s) >= n or not f:
            return s
        return s + (f * n)[:n - len(s)]

    def charAt(i=UNDEF):
        k = int(js_num(i)) if i is not UNDEF else 0
        return s[k] if 0 <= k < len(s) else ""

    def charCodeAt(i=UNDEF):
        k = int(js_num(i)) if i is not UNDEF else 0
        return float(ord(s[k])) if 0 <= k < len(s) else NAN

    def indexOf(sub, *_):
        return float(s.find(js_str(sub)))

    def lastIndexOf(sub, *_):
        return float(s.rfind(js_str(sub)))

    table = {
        "slice": slice, "substring": substring, "split": split,
        "replace": replace, "replaceAll": replaceAll,
        "padStart": padStart, "padEnd": padEnd,
        "charAt": charAt, "charCodeAt": charCodeAt,
        "indexOf": indexOf, "lastIndexOf": lastIndexOf,
        "includes": lambda sub, *_: js_str(sub) in s,
        "startsWith": lambda sub, *_: s.startswith(js_str(sub)),
        "endsWith": lambda sub, *_: s.endswith(js_str(sub)),
        "toUpperCase": lambda: s.upper(),
        "toLowerCase": lambda: s.lower(),
        "trim": lambda: s.strip(),
        "repeat": lambda n: s * int(js_num(n)),
        "concat": lambda *vs: s + "".join(js_str(v) for v in vs),
        "toString": lambda: s,
        "localeCompare": lambda o: float((s > js_str(o)) - (s < js_str(o))),
    }
    return table.get(name)


def _number_methods(f: float, name):
    def toFixed(d=UNDEF):
        n = int(js_num(d)) if d is not UNDEF else 0
        return f"{f:.{n}f}"

    table = {
        "toFixed": toFixed,
        "toString": lambda *a: _fmt_num(f) if not a else _int_to_radix(int(f), int(js_num(a[0]))),
    }
    return table.get(name)


def _int_to_radix(i, radix):
    if radix == 10:
        return str(i)
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    if i == 0:
        return "0"
    neg, i = i < 0, abs(i)
    out = []
    while i:
        out.append(digits[i % radix])
        i //= radix
    return ("-" if neg else "") + "".join(reversed(out))


def get_prop(obj, name, interp):
    if obj is UNDEF or obj is NULL:
        throw_error(f"Cannot read properties of {js_str(obj)} (reading '{name}')")
    if isinstance(obj, JSArray):
        if name == "length":
            return float(len(obj.items))
        m = _array_methods(obj, name, interp)
        if m is not None:
            return m
        try:
            i = int(name)
            if 0 <= i < len(obj.items):
                return obj.items[i]
        except (ValueError, TypeError):
            pass
        return UNDEF
    if isinstance(obj, str):
        if name == "length":
            return float(len(obj))
        m = _string_methods(obj, name, interp)
        if m is not None:
            return m
        try:
            i = int(name)
            return obj[i] if 0 <= i < len(obj) else UNDEF
        except (ValueError, TypeError):
            return UNDEF
    if isinstance(obj, bool):
        return UNDEF
    if isinstance(obj, (int, float)):
        m = _number_methods(float(obj), name)
        return m if m is not None else UNDEF
    if isinstance(obj, JSPromise):
        return _promise_methods(obj, name, interp)
    if isinstance(obj, JSFunction):
        if name == "name":
            return obj.name
        if name == "call":
            return lambda this=UNDEF, *args: interp.call(obj, this, list(args))
        if name == "bind":
            return lambda this=UNDEF, *pre: (
                lambda *args: interp.call(obj, this, list(pre) + list(args)))
        return UNDEF
    if hasattr(obj, "js_get"):
        return obj.js_get(name)
    throw_error(f"cannot read property '{name}' of {obj!r}")


def set_prop(obj, name, value, interp):
    if obj is UNDEF or obj is NULL:
        throw_error(f"Cannot set properties of {js_str(obj)} (setting '{name}')")
    if isinstance(obj, JSArray):
        if name == "length":
            n = int(js_num(value))
            del obj.items[n:]
            obj.items.extend([UNDEF] * (n - len(obj.items)))
            return
        try:
            i = int(name)
        except (ValueError, TypeError):
            return  # expando on arrays unsupported
        if i >= len(obj.items):
            obj.items.extend([UNDEF] * (i + 1 - len(obj.items)))
        obj.items[i] = value
        return
    if hasattr(obj, "js_set"):
        obj.js_set(name, value)
        return
    # setting on primitives is silently ignored (non-strict JS)


def _promise_methods(p: JSPromise, name, interp):
    def then(on_ok=UNDEF, on_err=UNDEF):
        if p.error is None:
            if on_ok is UNDEF:
                return p
            try:
                v = interp.call(on_ok, UNDEF, [p.value])
                return v if isinstance(v, JSPromise) else JSPromise(v)
            except JSThrow as t:
                return JSPromise(error=t)
        if on_err is not UNDEF:
            try:
                v = interp.call(on_err, UNDEF, [p.error.value])
                return v if isinstance(v, JSPromise) else JSPromise(v)
            except JSThrow as t:
                return JSPromise(error=t)
        return p

    def catch(on_err=UNDEF):
        return then(UNDEF, on_err)

    def finally_(f=UNDEF):
        if f is not UNDEF:
            interp.call(f, UNDEF, [])
        return p

    return {"then": then, "catch": catch, "finally": finally_}.get(name, UNDEF)


# --------------------------------------------------------------------------
# environments
# --------------------------------------------------------------------------

class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None, vars=None):
        self.parent = parent
        self.vars = vars if vars is not None else {}

    def lookup(self, name):
        e = self
        while True:
            if name in e.vars:
                return e.vars[name]
            if e.parent is None:
                break
            e = e.parent
        miss = getattr(e, "lookup_missing", None)
        if miss is not None:
            return miss(name)
        throw_error(f"{name} is not defined")

    def has(self, name):
        e = self
        while True:
            if name in e.vars:
                return True
            if e.parent is None:
                break
            e = e.parent
        miss = getattr(e, "has_missing", None)
        return miss(name) if miss is not None else False

    def declare(self, name, value):
        self.vars[name] = value

    def assign(self, name, value):
        e = self
        while e is not None:
            if name in e.vars:
                hooks = getattr(e, "assign_hooks", None)
                if hooks is not None and name in hooks and hooks[name](value):
                    return
                e.vars[name] = value
                return
            e = e.parent
        # implicit global (non-strict)
        g = self
        while g.parent is not None:
            g = g.parent
        hooks = getattr(g, "assign_hooks", None)
        if hooks is not None and name in hooks and hooks[name](value):
            return
        g.vars[name] = value


class GlobalEnv(Env):
    """Global scope with assignment hooks (used for `location = url`);
    Env.assign consults `assign_hooks` on the owning scope."""

    def __init__(self, assign_hooks=None):
        super().__init__(None)
        self.assign_hooks = assign_hooks or {}


# --------------------------------------------------------------------------
# interpreter
# --------------------------------------------------------------------------

class Interpreter:
    def __init__(self, global_env: Env):
        self.genv = global_env

    # -- calls --------------------------------------------------------------
    def call(self, fn, this, args):
        if isinstance(fn, JSFunction):
            env = Env(fn.env)
            self._bind_params(fn.params, args, env)
            if fn.is_arrow:
                env.declare("this", fn.this_val)
            else:
                env.declare("this", this)
                env.declare("arguments", JSArray(list(args)))
            try:
                if fn.body[0] == "block":
                    self.exec_block(fn.body, env)
                    result = UNDEF
                else:
                    result = self.eval(fn.body, env)
            except _Return as r:
                result = r.value
            except JSThrow as t:
                if fn.is_async:
                    return JSPromise(error=t)
                raise
            if fn.is_async and not isinstance(result, JSPromise):
                return JSPromise(result)
            return result
        if callable(fn):
            out = fn(*_fit_args(fn, args))
            return UNDEF if out is None else out
        throw_error(f"{js_str(fn)} is not a function")

    def _bind_params(self, params, args, env):
        for i, p in enumerate(params):
            if p[0] == "prest":
                self._bind_pattern(p[1], JSArray(list(args[i:])), env)
                return
            self._bind_pattern(p, args[i] if i < len(args) else UNDEF, env)

    def _bind_pattern(self, pat, value, env):
        tag = pat[0]
        if tag == "pid":
            env.declare(pat[1], value)
        elif tag == "pdefault":
            if value is UNDEF:
                value = self.eval(pat[2], env)
            self._bind_pattern(pat[1], value, env)
        elif tag == "parr":
            items = js_iter(value)
            i = 0
            for p in pat[1]:
                if p is None:
                    i += 1
                    continue
                if p[0] == "prest":
                    self._bind_pattern(p[1], JSArray(items[i:]), env)
                    return
                self._bind_pattern(p, items[i] if i < len(items) else UNDEF, env)
                i += 1
        elif tag == "pobj":
            for key, p, _ in pat[1]:
                if key == "..." or p[0] == "prest":
                    continue  # object rest unsupported (unused by the UI)
                self._bind_pattern(p, get_prop(value, key, self), env)
        else:  # pragma: no cover
            raise AssertionError(f"bad pattern {pat}")

    # -- statements -----------------------------------------------------------
    def run(self, ast, env=None):
        env = env or self.genv
        assert ast[0] == "program"
        self._hoist(ast[1], env)
        for s in ast[1]:
            self.exec_stmt(s, env)

    def _hoist(self, stmts, env):
        for s in stmts:
            if s[0] == "func":
                env.declare(s[1], JSFunction(s[1], s[2], s[3], env, False, s[4]))

    def exec_block(self, block, env):
        inner = Env(env)
        self._hoist(block[1], inner)
        for s in block[1]:
            self.exec_stmt(s, inner)

    def exec_stmt(self, s, env):
        tag = s[0]
        if tag == "expr":
            self.eval(s[1], env)
        elif tag == "var":
            for pat, init in s[2]:
                v = self.eval(init, env) if init is not None else UNDEF
                self._bind_pattern(pat, v, env)
        elif tag == "func":
            pass  # hoisted
        elif tag == "return":
            raise _Return(self.eval(s[1], env) if s[1] is not None else UNDEF)
        elif tag == "if":
            if truthy(self.eval(s[1], env)):
                self.exec_stmt(s[2], env)
            elif s[3] is not None:
                self.exec_stmt(s[3], env)
        elif tag == "block":
            self.exec_block(s, env)
        elif tag == "for":
            inner = Env(env)
            if s[1] is not None:
                self.exec_stmt(s[1], inner)
            while s[2] is None or truthy(self.eval(s[2], inner)):
                try:
                    self.exec_stmt(s[4], inner)
                except _Break:
                    break
                except _Continue:
                    pass
                if s[3] is not None:
                    self.eval(s[3], inner)
        elif tag == "forof":
            for item in js_iter(self.eval(s[3], env)):
                inner = Env(env)
                self._bind_pattern(s[2], item, inner)
                try:
                    self.exec_stmt(s[4], inner)
                except _Break:
                    break
                except _Continue:
                    pass
        elif tag == "forin":
            obj = self.eval(s[3], env)
            keys = []
            if isinstance(obj, JSObject):
                keys = list(obj.props.keys())
            elif isinstance(obj, JSArray):
                keys = [str(i) for i in range(len(obj.items))]
            elif hasattr(obj, "props"):
                keys = list(obj.props.keys())
            for k in keys:
                inner = Env(env)
                self._bind_pattern(s[2], k, inner)
                try:
                    self.exec_stmt(s[4], inner)
                except _Break:
                    break
                except _Continue:
                    pass
        elif tag == "while":
            while truthy(self.eval(s[1], env)):
                try:
                    self.exec_stmt(s[2], env)
                except _Break:
                    break
                except _Continue:
                    pass
        elif tag == "dowhile":
            while True:
                try:
                    self.exec_stmt(s[1], env)
                except _Break:
                    break
                except _Continue:
                    pass
                if not truthy(self.eval(s[2], env)):
                    break
        elif tag == "break":
            raise _Break()
        elif tag == "continue":
            raise _Continue()
        elif tag == "throw":
            raise JSThrow(self.eval(s[1], env))
        elif tag == "try":
            try:
                self.exec_stmt(s[1], env)
            except JSThrow as t:
                if s[3] is not None:
                    inner = Env(env)
                    if s[2] is not None:
                        self._bind_pattern(s[2], t.value, inner)
                    self._hoist(s[3][1], inner)
                    for st in s[3][1]:
                        self.exec_stmt(st, inner)
                elif s[4] is None:
                    raise
            finally:
                if s[4] is not None:
                    self.exec_stmt(s[4], env)
        elif tag == "empty":
            pass
        else:  # pragma: no cover
            raise AssertionError(f"unhandled stmt {tag}")

    # -- expressions ------------------------------------------------------------
    def eval(self, e, env):
        v = self._ev(e, env)
        return UNDEF if v is _CHAIN else v

    def _ev(self, e, env):
        tag = e[0]
        if tag == "__lit":  # pre-evaluated value (compound assignment reuse)
            return e[1]
        if tag == "num":
            return e[1]
        if tag == "str":
            return e[1]
        if tag == "bool":
            return e[1]
        if tag == "null":
            return NULL
        if tag == "undef":
            return UNDEF
        if tag == "ident":
            return env.lookup(e[1])
        if tag == "this":
            return env.lookup("this") if env.has("this") else UNDEF
        if tag == "tmpl":
            out = []
            for kind, v in e[1]:
                out.append(v if kind == "s" else js_str(self.eval(v, env)))
            return "".join(out)
        if tag == "arr":
            items = []
            for el in e[1]:
                if el[0] == "spread":
                    items.extend(js_iter(self.eval(el[1], env)))
                else:
                    items.append(self.eval(el, env))
            return JSArray(items)
        if tag == "obj":
            props = {}
            for kind, key, v in e[1]:
                if kind == "spread":
                    sv = self.eval(v, env)
                    if isinstance(sv, JSObject):
                        props.update(sv.props)
                    elif isinstance(sv, JSArray):
                        for i, x in enumerate(sv.items):
                            props[str(i)] = x
                    elif hasattr(sv, "props"):
                        props.update(sv.props)
                    # spreading null/undefined is a no-op
                else:
                    k = js_str(self.eval(key[1], env)) if isinstance(key, tuple) else key
                    props[k] = self.eval(v, env)
            return JSObject(props)
        if tag == "funcexpr":
            return JSFunction(e[1], e[2], e[3], env, False, e[4])
        if tag == "arrow":
            this_val = env.lookup("this") if env.has("this") else UNDEF
            return JSFunction(None, e[1], e[2] if not e[3] else e[2], env, True, e[4],
                              this_val)
        if tag == "member":
            obj = self._ev(e[1], env)
            if obj is _CHAIN:
                return _CHAIN
            if e[3] and (obj is UNDEF or obj is NULL):
                return _CHAIN
            return get_prop(obj, e[2], self)
        if tag == "index":
            obj = self._ev(e[1], env)
            if obj is _CHAIN:
                return _CHAIN
            if e[3] and (obj is UNDEF or obj is NULL):
                return _CHAIN
            key = self.eval(e[2], env)
            return get_prop(obj, _index_key(key), self)
        if tag == "call":
            return self._ev_call(e, env)
        if tag == "new":
            callee = self.eval(e[1], env)
            args = self._eval_args(e[2], env)
            if hasattr(callee, "js_construct"):
                return callee.js_construct(*args)
            if isinstance(callee, JSFunction):
                obj = JSObject()
                r = self.call(callee, obj, args)
                return r if isinstance(r, (JSObject, JSArray)) else obj
            if callable(callee):
                out = callee(*args)
                return UNDEF if out is None else out
            throw_error(f"{js_str(callee)} is not a constructor")
        if tag == "binop":
            return self._binop(e[1], e[2], e[3], env)
        if tag == "unary":
            return self._unary(e[1], e[2], env)
        if tag == "update":
            return self._update(e, env)
        if tag == "assign":
            return self._assign(e, env)
        if tag == "cond":
            return self.eval(e[2] if truthy(self.eval(e[1], env)) else e[3], env)
        if tag == "seq":
            v = UNDEF
            for sub in e[1]:
                v = self.eval(sub, env)
            return v
        if tag == "await":
            v = self.eval(e[1], env)
            if isinstance(v, JSPromise):
                if v.error is not None:
                    raise v.error
                return v.value
            return v
        if tag == "regex":
            from .dom import JSRegExp
            return JSRegExp(e[1], e[2])
        if tag == "spread":  # pragma: no cover — consumed by arr/call/obj
            throw_error("unexpected spread")
        raise AssertionError(f"unhandled expr {tag}")  # pragma: no cover

    def _eval_args(self, arg_nodes, env):
        args = []
        for a in arg_nodes:
            if a[0] == "spread":
                args.extend(js_iter(self.eval(a[1], env)))
            else:
                args.append(self.eval(a, env))
        return args

    def _ev_call(self, e, env):
        callee = e[1]
        this = UNDEF
        if callee[0] in ("member", "index"):
            obj = self._ev(callee[1], env)
            if obj is _CHAIN:
                return _CHAIN
            if callee[3] and (obj is UNDEF or obj is NULL):
                return _CHAIN
            name = callee[2] if callee[0] == "member" else _index_key(self.eval(callee[2], env))
            fn = get_prop(obj, name, self)
            this = obj
        else:
            fn = self._ev(callee, env)
            if fn is _CHAIN:
                return _CHAIN
        if e[3] and (fn is UNDEF or fn is NULL):  # optional call f?.()
            return _CHAIN
        args = self._eval_args(e[2], env)
        return self.call(fn, this, args)

    def _binop(self, op, ln, rn, env):
        if op == "&&":
            lv = self.eval(ln, env)
            return self.eval(rn, env) if truthy(lv) else lv
        if op == "||":
            lv = self.eval(ln, env)
            return lv if truthy(lv) else self.eval(rn, env)
        if op == "??":
            lv = self.eval(ln, env)
            return self.eval(rn, env) if lv is UNDEF or lv is NULL else lv
        lv = self.eval(ln, env)
        rv = self.eval(rn, env)
        if op == "+":
            if isinstance(lv, str) or isinstance(rv, str) or \
               isinstance(lv, (JSArray, JSObject)) or isinstance(rv, (JSArray, JSObject)):
                return js_str(lv) + js_str(rv)
            return js_num(lv) + js_num(rv)
        if op == "-":
            return js_num(lv) - js_num(rv)
        if op == "*":
            return js_num(lv) * js_num(rv)
        if op == "/":
            d = js_num(rv)
            n = js_num(lv)
            if d == 0:
                return NAN if n == 0 or math.isnan(n) else math.copysign(math.inf, n * (1 if math.copysign(1, d) > 0 else -1))
            return n / d
        if op == "%":
            d = js_num(rv)
            n = js_num(lv)
            if d == 0 or math.isnan(n) or math.isinf(n):
                return NAN
            return math.fmod(n, d)
        if op == "**":
            return js_num(lv) ** js_num(rv)
        if op == "==":
            return loose_eq(lv, rv)
        if op == "!=":
            return not loose_eq(lv, rv)
        if op == "===":
            return strict_eq(lv, rv)
        if op == "!==":
            return not strict_eq(lv, rv)
        if op in ("<", ">", "<=", ">="):
            if isinstance(lv, str) and isinstance(rv, str):
                a, b = lv, rv
            else:
                a, b = js_num(lv), js_num(rv)
                if math.isnan(a) or math.isnan(b):
                    return False
            return {"<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b}[op]
        if op == "&":
            return float(to_int32(lv) & to_int32(rv))
        if op == "|":
            return float(to_int32(lv) | to_int32(rv))
        if op == "^":
            return float(to_int32(lv) ^ to_int32(rv))
        if op == "<<":
            return float(to_int32(to_int32(lv) << (to_int32(rv) & 31)))
        if op == ">>":
            return float(to_int32(lv) >> (to_int32(rv) & 31))
        if op == ">>>":
            return float((to_int32(lv) & 0xFFFFFFFF) >> (to_int32(rv) & 31))
        if op == "in":
            if isinstance(rv, JSArray):
                i = int(js_num(lv))
                return 0 <= i < len(rv.items)
            if hasattr(rv, "props"):
                return js_str(lv) in rv.props
            return False
        if op == "instanceof":
            return False  # no class hierarchy in the subset
        raise AssertionError(f"unhandled binop {op}")  # pragma: no cover

    def _unary(self, op, node, env):
        if op == "typeof":
            if node[0] == "ident" and not env.has(node[1]):
                return "undefined"
            v = self.eval(node, env)
            if v is UNDEF:
                return "undefined"
            if v is NULL:
                return "object"
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, (int, float)):
                return "number"
            if isinstance(v, str):
                return "string"
            if isinstance(v, JSFunction) or callable(v):
                return "function"
            return "object"
        v = self.eval(node, env)
        if op == "!":
            return not truthy(v)
        if op == "-":
            return -js_num(v)
        if op == "+":
            return js_num(v)
        if op == "~":
            return float(~to_int32(v))
        if op == "void":
            return UNDEF
        if op == "delete":
            if node[0] == "member":
                obj = self.eval(node[1], env)
                if hasattr(obj, "props"):
                    obj.props.pop(node[2], None)
            elif node[0] == "index":
                obj = self.eval(node[1], env)
                key = _index_key(self.eval(node[2], env))
                if hasattr(obj, "props"):
                    obj.props.pop(key, None)
            return True
        raise AssertionError(f"unhandled unary {op}")  # pragma: no cover

    def _update(self, e, env):
        _, op, prefix, target = e
        old = js_num(self._read_target(target, env))
        new = old + (1.0 if op == "++" else -1.0)
        self._write_target(target, new, env)
        return new if prefix else old

    def _assign(self, e, env):
        _, op, target, value_node = e
        if op == "=":
            v = self.eval(value_node, env)
        elif op in ("&&=", "||=", "??="):
            cur = self._read_target(target, env)
            if op == "&&=" and not truthy(cur):
                return cur
            if op == "||=" and truthy(cur):
                return cur
            if op == "??=" and not (cur is UNDEF or cur is NULL):
                return cur
            v = self.eval(value_node, env)
        else:
            cur = self._read_target(target, env)
            rhs = self.eval(value_node, env)
            v = self._binop(op[:-1], ("__lit", cur), ("__lit", rhs), env)
        self._write_target(target, v, env)
        return v

    def _read_target(self, t, env):
        if t[0] == "ident":
            return env.lookup(t[1]) if env.has(t[1]) else UNDEF
        if t[0] == "member":
            return get_prop(self.eval(t[1], env), t[2], self)
        if t[0] == "index":
            return get_prop(self.eval(t[1], env), _index_key(self.eval(t[2], env)), self)
        throw_error("invalid assignment target")

    def _write_target(self, t, v, env):
        if t[0] == "ident":
            env.assign(t[1], v)
        elif t[0] == "member":
            set_prop(self.eval(t[1], env), t[2], v, self)
        elif t[0] == "index":
            set_prop(self.eval(t[1], env), _index_key(self.eval(t[2], env)), v, self)
        else:
            throw_error("invalid assignment target")


def _index_key(key) -> str:
    if isinstance(key, bool):
        return "true" if key else "false"
    if isinstance(key, float):
        return _fmt_num(key)
    if isinstance(key, int):
        return str(key)
    return js_str(key)


# --------------------------------------------------------------------------
# JS <-> Python value conversion (for fetch routers and assertions)
# --------------------------------------------------------------------------

def to_js(v):
    """Convert a Python structure (e.g. parsed JSON) to JS values."""
    if v is None:
        return NULL
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return v
    if isinstance(v, (list, tuple)):
        return JSArray([to_js(x) for x in v])
    if isinstance(v, dict):
        return JSObject({str(k): to_js(x) for k, x in v.items()})
    return v


def to_py(v):
    """Convert JS values to Python (UNDEF -> None)."""
    if v is UNDEF or v is NULL:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return int(v) if v.is_integer() and abs(v) < 2**53 else v
    if isinstance(v, str):
        return v
    if isinstance(v, JSArray):
        return [to_py(x) for x in v.items]
    if isinstance(v, JSObject):
        return {k: to_py(x) for k, x in v.props.items()}
    if hasattr(v, "props"):
        return {k: to_py(x) for k, x in v.props.items()}
    return v


def json_stringify(v, indent=None) -> str:
    def conv(x):
        if x is UNDEF:
            return None  # handled by callers: undefined in arrays -> null
        if x is NULL:
            return None
        if isinstance(x, bool):
            return x
        if isinstance(x, float):
            return int(x) if x.is_integer() and abs(x) < 2**53 else x
        if isinstance(x, str):
            return x
        if isinstance(x, JSArray):
            return [None if (it is UNDEF or isinstance(it, JSFunction) or callable(it))
                    else conv(it) for it in x.items]
        if isinstance(x, JSObject) or hasattr(x, "props"):
            out = {}
            for k, val in x.props.items():
                if val is UNDEF or isinstance(val, JSFunction) or callable(val):
                    continue
                out[k] = conv(val)
            return out
        return None
    if v is UNDEF or isinstance(v, JSFunction) or callable(v):
        return "undefined"
    return _json.dumps(conv(v), separators=(",", ":") if indent is None else None,
                       indent=indent)


def json_parse(s: str):
    try:
        return to_js(_json.loads(s))
    except Exception:
        throw_error("Unexpected token in JSON")
