"""Fake DOM + browser environment for executing the repo's UI scripts.

Implements the browser surface mainview.html / cameraview.html actually use
(see jsengine/__init__): a document tree parsed with html.parser, live
``innerHTML`` re-parsing, id lookup, a small CSS-selector engine
(tag / #id / .class / [attr] / [attr^=] / descendant / comma groups),
event dispatch with bubbling and inline-attribute handlers, ``<select>`` /
``<option>`` / ``<dialog>`` semantics, canvas-2D call recording, timers the
test harness fires deterministically, and a pluggable ``fetch`` (canned
routes or a LIVE proxy to a real clearcam_tpu server over urllib — that
variant executes the UI against the product's actual HTTP responses).

Everything is synchronous: promises settle eagerly (interp.JSPromise), so a
test drives ``browser.call('loadCameras')`` and immediately asserts on the
DOM.
"""

from __future__ import annotations

import base64
import datetime as _dt
import html.parser
import json as _json
import re as _re
import urllib.parse
import urllib.request

from . import es
from .interp import (
    NULL, UNDEF, Env, GlobalEnv, Interpreter, JSArray, JSFunction, JSObject,
    JSPromise, JSThrow, js_iter, js_num, js_str, json_parse, json_stringify,
    throw_error, to_js, truthy,
)

VOID_TAGS = {"area", "base", "br", "col", "embed", "hr", "img", "input",
             "link", "meta", "param", "source", "track", "wbr"}


class JSRegExp:
    """Minimal regex literal support (the UI currently uses none)."""

    js_regex = True

    def __init__(self, pattern, flags):
        self.source, self.flags = pattern, flags
        pyflags = 0
        if "i" in flags:
            pyflags |= _re.IGNORECASE
        if "m" in flags:
            pyflags |= _re.MULTILINE
        if "s" in flags:
            pyflags |= _re.DOTALL
        self.re = _re.compile(pattern, pyflags)

    def js_get(self, name):
        if name == "test":
            return lambda s: self.re.search(js_str(s)) is not None
        if name == "source":
            return self.source
        return UNDEF

    def js_set(self, name, value):
        pass

    def js_replace(self, s, rep, interp):
        count = 0 if "g" in self.flags else 1
        if isinstance(rep, JSFunction) or callable(rep):
            return self.re.sub(
                lambda m: js_str(interp.call(rep, UNDEF, [m.group(0), *m.groups()])),
                s, count=count)
        return self.re.sub(js_str(rep).replace("\\", "\\\\"), s, count=count)


# --------------------------------------------------------------------------
# DOM tree
# --------------------------------------------------------------------------

class ClassList:
    def __init__(self, el):
        self.el = el

    def _get(self):
        return [c for c in (self.el.attrs.get("class") or "").split() if c]

    def _put(self, classes):
        self.el.attrs["class"] = " ".join(classes)

    def js_get(self, name):
        if name == "add":
            def add(*cs):
                cur = self._get()
                for c in cs:
                    c = js_str(c)
                    if c not in cur:
                        cur.append(c)
                self._put(cur)
            return add
        if name == "remove":
            def remove(*cs):
                cur = [c for c in self._get() if c not in [js_str(x) for x in cs]]
                self._put(cur)
            return remove
        if name == "toggle":
            def toggle(c, force=UNDEF):
                c = js_str(c)
                cur = self._get()
                want = (c not in cur) if force is UNDEF else truthy(force)
                if want and c not in cur:
                    cur.append(c)
                if not want and c in cur:
                    cur.remove(c)
                self._put(cur)
                return want
            return toggle
        if name == "contains":
            return lambda c: js_str(c) in self._get()
        if name == "length":
            return float(len(self._get()))
        return UNDEF

    def js_set(self, name, value):
        pass


class Ctx2D:
    """Records every draw call; tests assert on the op list."""

    def __init__(self, canvas):
        self.canvas = canvas
        self.ops = []
        self.state = {}

    def js_get(self, name):
        draw = {"clearRect", "beginPath", "moveTo", "lineTo", "closePath",
                "fill", "stroke", "arc", "strokeRect", "fillRect", "fillText",
                "strokeText", "drawImage", "rect"}
        if name in draw:
            def op(*args, _n=name):
                self.ops.append((_n, tuple(js_str(a) if isinstance(a, str) else js_num(a)
                                           if isinstance(a, (int, float, bool)) else a
                                           for a in args)))
            return op
        return self.state.get(name, UNDEF)

    def js_set(self, name, value):
        self.state[name] = value
        self.ops.append(("set:" + name, (value,)))


class Element:
    def __init__(self, tag, doc):
        self.tag = tag.lower()
        self.doc = doc
        self.attrs = {}
        self.children = []  # Elements and strings (text nodes)
        self.parent = None
        self.props = {}  # JS expando properties
        self.listeners = {}  # type -> [(fn, once)]
        self._ctx = None
        self.rect = (0.0, 0.0, 640.0, 360.0)  # left, top, width, height

    # -- tree helpers ---------------------------------------------------------
    def _elements(self):
        return [c for c in self.children if isinstance(c, Element)]

    def walk(self):
        for c in self._elements():
            yield c
            yield from c.walk()

    def append(self, child):
        if isinstance(child, Element):
            if child.parent is not None:
                child.parent.children.remove(child)
            child.parent = self
        self.children.append(child)

    def detach(self):
        if self.parent is not None:
            self.parent.children.remove(self)
            self.parent = None

    def replace_with(self, other):
        if self.parent is None:
            return
        idx = self.parent.children.index(self)
        other.detach()
        other.parent = self.parent
        self.parent.children[idx] = other
        self.parent = None

    def text(self) -> str:
        out = []
        for c in self.children:
            out.append(c.text() if isinstance(c, Element) else c)
        return "".join(out)

    # -- serialization --------------------------------------------------------
    def inner_html(self) -> str:
        return "".join(c.outer_html() if isinstance(c, Element) else _esc(c)
                       for c in self.children)

    def outer_html(self) -> str:
        attrs = "".join(
            f' {k}' if v is None else f' {k}="{_esc(str(v))}"'
            for k, v in self.attrs.items())
        if self.tag in VOID_TAGS:
            return f"<{self.tag}{attrs}>"
        return f"<{self.tag}{attrs}>{self.inner_html()}</{self.tag}>"

    def set_inner_html(self, src: str):
        self.children = []
        frag = parse_html_fragment(src, self.doc)
        for c in frag:
            self.append(c)

    # -- selector engine ------------------------------------------------------
    def matches(self, simple: str) -> bool:
        """Match one compound selector (tag#id.class[attr^="v"])."""
        i, n = 0, len(simple)
        while i < n:
            if simple[i] == "#":
                j = i + 1
                while j < n and simple[j] not in "#.[":
                    j += 1
                if self.attrs.get("id") != simple[i + 1:j]:
                    return False
                i = j
            elif simple[i] == ".":
                j = i + 1
                while j < n and simple[j] not in "#.[":
                    j += 1
                if simple[i + 1:j] not in (self.attrs.get("class") or "").split():
                    return False
                i = j
            elif simple[i] == "[":
                j = simple.index("]", i)
                body = simple[i + 1:j]
                if "^=" in body:
                    k, v = body.split("^=", 1)
                    v = v.strip("\"'")
                    if not str(self.attrs.get(k.strip(), "")).startswith(v):
                        return False
                elif "=" in body:
                    k, v = body.split("=", 1)
                    v = v.strip("\"'")
                    if str(self.attrs.get(k.strip())) != v:
                        return False
                else:
                    if body.strip() not in self.attrs:
                        return False
                i = j + 1
            else:
                j = i
                while j < n and simple[j] not in "#.[":
                    j += 1
                if self.tag != simple[i:j].lower():
                    return False
                i = j
        return True

    def select(self, selector: str):
        out = []
        for group in selector.split(","):
            parts = group.split()
            if not parts:
                continue
            candidates = list(self.walk())
            # descendant combinator: filter by each ancestor part
            def has_ancestor_chain(el, chain):
                if not chain:
                    return True
                anc = el.parent
                want = chain[-1]
                while anc is not None:
                    if isinstance(anc, Element) and anc.matches(want) and \
                       has_ancestor_chain(anc, chain[:-1]):
                        return True
                    anc = anc.parent
                return False
            for el in candidates:
                if el.matches(parts[-1]) and has_ancestor_chain(el, parts[:-1]) \
                        and el not in out:
                    out.append(el)
        return out

    # -- events ----------------------------------------------------------------
    def add_listener(self, type_, fn, opts=UNDEF):
        once = False
        if isinstance(opts, JSObject):
            once = truthy(opts.props.get("once", False))
        self.listeners.setdefault(js_str(type_), []).append([fn, once])

    def fire(self, type_, event):
        """Fire this element's handlers for an event type (no bubbling)."""
        interp = self.doc.browser.interp
        # inline attribute handler
        attr_src = self.attrs.get("on" + type_)
        if attr_src:
            env = Env(self.doc.browser.genv)
            env.declare("event", event)
            env.declare("this", self)
            interp.run(es.parse(attr_src), env)
        # property handler
        prop = self.props.get("on" + type_)
        if prop is not None and prop is not UNDEF and prop is not NULL:
            interp.call(prop, self, [event])
        for entry in list(self.listeners.get(type_, [])):
            fn, once = entry
            if once:
                self.listeners[type_].remove(entry)
            interp.call(fn, self, [event])

    def dispatch(self, type_, **props):
        event = JSObject({"type": type_, "target": self, **{k: to_js(v) for k, v in props.items()}})
        node = self
        while node is not None:
            node.fire(type_, event)
            node = node.parent
        self.doc.fire(type_, event)
        return event

    # -- JS property surface ----------------------------------------------------
    def js_get(self, name):
        a = self.attrs
        if name == "id":
            return a.get("id", "")
        if name == "tagName":
            return self.tag.upper()
        if name == "className":
            return a.get("class", "")
        if name == "classList":
            return ClassList(self)
        if name == "dataset":
            return _Dataset(self)
        if name == "style":
            return self.props.setdefault("__style", _Style(self))
        if name == "innerHTML":
            return self.inner_html()
        if name == "outerHTML":
            return self.outer_html()
        if name == "textContent":
            return self.text()
        if name == "children":
            return JSArray(self._elements())
        if name == "firstChild":
            return self.children[0] if self.children else NULL
        if name == "parentElement" or name == "parentNode":
            return self.parent if self.parent is not None else NULL
        if name == "value":
            if self.tag == "select":
                return self._select_value()
            if self.tag == "option":
                return a.get("value", self.text()) or ("" if "value" in a else self.text())
            return self.props.get("value", a.get("value", "") or "")
        if name == "checked":
            if "checked" in self.props:
                return self.props["checked"]
            return "checked" in a
        if name == "selected":
            return self.props.get("selected", "selected" in a)
        if name == "options":
            return JSArray([e for e in self.walk() if e.tag == "option"])
        if name == "selectedOptions":
            return JSArray([o for o in self.walk() if o.tag == "option"
                            and truthy(self._opt_selected(o))])
        if name == "files":
            return self.props.get("files", JSArray([]))
        if name == "open":
            return "open" in a or self.props.get("open", False)
        if name in ("clientWidth", "offsetWidth"):
            return self.props.get("clientWidth", self.rect[2])
        if name in ("clientHeight", "offsetHeight"):
            return self.props.get("clientHeight", self.rect[3])
        if name == "width":
            return self.props.get("width", js_num(a.get("width", 300.0)))
        if name == "height":
            return self.props.get("height", js_num(a.get("height", 150.0)))
        # methods
        m = self._methods(name)
        if m is not None:
            return m
        if name in self.props:
            return self.props[name]
        if name.startswith("on"):
            return self.props.get(name, UNDEF)
        if name in a:
            return a[name] if a[name] is not None else True
        return UNDEF

    def _opt_selected(self, o):
        return o.props.get("selected", "selected" in o.attrs)

    def _select_value(self):
        opts = [e for e in self.walk() if e.tag == "option"]
        if self.props.get("__novalue"):
            return ""
        for o in opts:
            if truthy(self._opt_selected(o)):
                return o.js_get("value")
        return opts[0].js_get("value") if opts else ""

    def _set_select_value(self, v):
        v = js_str(v)
        opts = [e for e in self.walk() if e.tag == "option"]
        hit = False
        for o in opts:
            match = js_str(o.js_get("value")) == v
            o.props["selected"] = match
            hit = hit or match
        self.props["__novalue"] = not hit

    def _methods(self, name):
        doc = self.doc

        def appendChild(child):
            self.append(child)
            return child

        def removeChild(child):
            child.detach()
            return child

        def remove():
            self.detach()

        def replaceWith(other):
            self.replace_with(other)

        def insertAdjacentHTML(where, src):
            frag = parse_html_fragment(js_str(src), doc)
            if js_str(where) == "beforeend":
                for c in frag:
                    self.append(c)
            elif js_str(where) == "afterbegin":
                for c in reversed(frag):
                    if isinstance(c, Element):
                        c.parent = self
                    self.children.insert(0, c)
            return UNDEF

        def addEventListener(type_, fn, opts=UNDEF):
            self.add_listener(type_, fn, opts)

        def removeEventListener(type_, fn, opts=UNDEF):
            lst = self.listeners.get(js_str(type_), [])
            self.listeners[js_str(type_)] = [e for e in lst if e[0] is not fn]

        def click():
            self.dispatch("click", clientX=0.0, clientY=0.0)

        def play():
            self.props["playing"] = True
            doc.browser.played.append(self)
            return JSPromise(UNDEF)

        def pause():
            self.props["playing"] = False

        def canPlayType(t):
            return doc.browser.can_play_native.get(js_str(t), "")

        def getContext(kind):
            if self._ctx is None:
                self._ctx = Ctx2D(self)
            return self._ctx

        def getBoundingClientRect():
            left, top, w, h = self.rect
            return JSObject({"left": left, "top": top, "width": w, "height": h,
                             "right": left + w, "bottom": top + h, "x": left, "y": top})

        def showModal():
            self.props["open"] = True
            doc.browser.modals.append(self.attrs.get("id", self.tag))
            self.attrs["open"] = None

        def close():
            self.props["open"] = False
            self.attrs.pop("open", None)

        def scrollIntoView(opts=UNDEF):
            doc.browser.scrolled_to.append(self)

        def focus():
            doc.browser.focused = self

        def add(option, before=UNDEF):
            self.append(option)
            return UNDEF

        def querySelector(sel):
            found = self.select(js_str(sel))
            return found[0] if found else NULL

        def querySelectorAll(sel):
            return JSArray(self.select(js_str(sel)))

        def getAttribute(n):
            v = self.attrs.get(js_str(n))
            return NULL if v is None and js_str(n) not in self.attrs else (
                True if v is None else v)

        def setAttribute(n, v):
            self.attrs[js_str(n)] = js_str(v)

        def removeAttribute(n):
            self.attrs.pop(js_str(n), None)

        table = {
            "appendChild": appendChild, "removeChild": removeChild,
            "remove": remove, "replaceWith": replaceWith,
            "insertAdjacentHTML": insertAdjacentHTML,
            "addEventListener": addEventListener,
            "removeEventListener": removeEventListener,
            "click": click, "play": play, "pause": pause,
            "canPlayType": canPlayType, "getContext": getContext,
            "getBoundingClientRect": getBoundingClientRect,
            "showModal": showModal, "close": close,
            "scrollIntoView": scrollIntoView, "focus": focus,
            "querySelector": querySelector, "querySelectorAll": querySelectorAll,
            "getAttribute": getAttribute, "setAttribute": setAttribute,
            "removeAttribute": removeAttribute,
        }
        if self.tag == "select":
            table["add"] = add
        return table.get(name)

    def js_set(self, name, value):
        if name == "innerHTML":
            self.set_inner_html(js_str(value))
        elif name == "textContent":
            self.children = [js_str(value)]
        elif name == "id":
            self.attrs["id"] = js_str(value)
        elif name == "className":
            self.attrs["class"] = js_str(value)
        elif name == "value":
            if self.tag == "select":
                self._set_select_value(value)
            else:
                self.props["value"] = js_str(value)
        elif name in ("checked", "selected", "muted", "playsInline", "controls",
                      "hidden", "disabled", "loading"):
            self.props[name] = value
        elif name == "src":
            self.attrs["src"] = js_str(value)
            self.doc.browser.loads.append((self, js_str(value)))
        elif name in ("href", "target", "title", "alt", "placeholder"):
            self.attrs[name] = js_str(value)
        elif name in ("width", "height"):
            self.props[name] = js_num(value)
        elif name == "currentTime":
            self.props["currentTime"] = js_num(value)
            self.doc.browser.seeks.append((self, js_num(value)))
        else:
            self.props[name] = value

    def js_str(self):
        return f"[object HTML{self.tag.capitalize()}Element]"

    def __repr__(self):  # pragma: no cover
        i = self.attrs.get("id")
        return f"<{self.tag}{'#' + i if i else ''}>"


class _Dataset:
    def __init__(self, el):
        self.el = el

    def js_get(self, name):
        v = self.el.attrs.get("data-" + name)
        return UNDEF if v is None else v

    def js_set(self, name, value):
        self.el.attrs["data-" + name] = js_str(value)


class _Style(JSObject):
    def __init__(self, el):
        super().__init__()
        self.el = el

    def js_get(self, name):
        return self.props.get(name, "")

    def js_set(self, name, value):
        self.props[name] = js_str(value)


def _esc(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;")


class _FragmentParser(html.parser.HTMLParser):
    def __init__(self, doc):
        super().__init__(convert_charrefs=True)
        self.doc = doc
        self.root = Element("#fragment", doc)
        self.stack = [self.root]
        self.scripts = []

    def handle_starttag(self, tag, attrs):
        el = Element(tag, self.doc)
        for k, v in attrs:
            el.attrs[k] = v
        self.stack[-1].append(el)
        if tag not in VOID_TAGS:
            self.stack.append(el)

    def handle_startendtag(self, tag, attrs):
        el = Element(tag, self.doc)
        for k, v in attrs:
            el.attrs[k] = v
        self.stack[-1].append(el)

    def handle_endtag(self, tag):
        for i in range(len(self.stack) - 1, 0, -1):
            if self.stack[i].tag == tag:
                del self.stack[i:]
                break

    def handle_data(self, data):
        cur = self.stack[-1]
        if cur.tag == "script":
            self.scripts.append((cur, data))
        cur.children.append(data)


def parse_html_fragment(src: str, doc):
    p = _FragmentParser(doc)
    p.feed(src)
    p.close()
    return list(p.root.children)


# --------------------------------------------------------------------------
# document / window / standard library hosts
# --------------------------------------------------------------------------

class Document:
    def __init__(self, browser):
        self.browser = browser
        self.root = Element("#document", self)
        self.listeners = {}
        self.parent = None

    # Document quacks enough like Element for bubbling termination
    def fire(self, type_, event):
        interp = self.browser.interp
        for entry in list(self.listeners.get(type_, [])):
            fn, once = entry
            if once:
                self.listeners[type_].remove(entry)
            interp.call(fn, self, [event])

    def get_element_by_id(self, id_):
        for el in self.root.walk():
            if el.attrs.get("id") == id_:
                return el
        return None

    def js_get(self, name):
        if name == "body":
            for el in self.root.walk():
                if el.tag == "body":
                    return el
            return self.root
        if name == "documentElement":
            return self.root
        if name == "getElementById":
            def geid(i):
                el = self.get_element_by_id(js_str(i))
                return el if el is not None else NULL
            return geid
        if name == "createElement":
            return lambda tag: Element(js_str(tag), self)
        if name == "createTextNode":
            return lambda s: js_str(s)
        if name == "querySelector":
            def qs(sel):
                found = self.root.select(js_str(sel))
                return found[0] if found else NULL
            return qs
        if name == "querySelectorAll":
            return lambda sel: JSArray(self.root.select(js_str(sel)))
        if name == "addEventListener":
            def ael(type_, fn, opts=UNDEF):
                once = isinstance(opts, JSObject) and truthy(opts.props.get("once", False))
                self.listeners.setdefault(js_str(type_), []).append([fn, once])
            return ael
        if name == "title":
            return self.browser.title
        return UNDEF

    def js_set(self, name, value):
        if name == "title":
            self.browser.title = js_str(value)


class Location:
    def __init__(self, browser, href="/"):
        self.browser = browser
        self.href_val = href

    def navigate(self, url):
        self.browser.navigations.append(js_str(url))
        self.href_val = js_str(url)

    def js_get(self, name):
        if name == "href":
            return self.href_val
        if name == "search":
            i = self.href_val.find("?")
            return self.href_val[i:] if i >= 0 else ""
        if name == "reload":
            return lambda: self.browser.navigations.append("#reload")
        if name == "pathname":
            return self.href_val.split("?")[0]
        return UNDEF

    def js_set(self, name, value):
        if name == "href":
            self.navigate(value)


class _Table:
    """Host object from a dict of callables/values."""

    def __init__(self, table, construct=None):
        self.table = table
        self.construct = construct

    def js_get(self, name):
        return self.table.get(name, UNDEF)

    def js_set(self, name, value):
        self.table[name] = value

    def js_construct(self, *args):
        if self.construct is None:
            throw_error("not a constructor")
        return self.construct(*args)


class JSDate:
    def __init__(self, ms):
        self.ms = float(ms)

    def js_get(self, name):
        t = _dt.datetime.fromtimestamp(self.ms / 1000.0, _dt.timezone.utc)
        table = {
            "toISOString": lambda: t.strftime("%Y-%m-%dT%H:%M:%S.") + f"{int(t.microsecond/1000):03d}Z",
            "getTime": lambda: self.ms,
            "valueOf": lambda: self.ms,
            "getHours": lambda: float(t.hour),
            "getMinutes": lambda: float(t.minute),
            "getSeconds": lambda: float(t.second),
            "getFullYear": lambda: float(t.year),
            "getMonth": lambda: float(t.month - 1),
            "getDate": lambda: float(t.day),
            "getDay": lambda: float((t.weekday() + 1) % 7),
            "toLocaleTimeString": lambda *a: t.strftime("%H:%M:%S"),
            "toLocaleDateString": lambda *a: t.strftime("%Y-%m-%d"),
            "toLocaleString": lambda *a: t.strftime("%Y-%m-%d %H:%M:%S"),
        }
        return table.get(name, UNDEF)

    def js_set(self, name, value):
        pass


class URLSearchParamsObj:
    def __init__(self, init=UNDEF):
        self.pairs = []
        if isinstance(init, JSObject):
            for k, v in init.props.items():
                self.pairs.append([k, js_str(v)])
        elif isinstance(init, str):
            q = init[1:] if init.startswith("?") else init
            for part in q.split("&"):
                if part:
                    k, _, v = part.partition("=")
                    self.pairs.append([urllib.parse.unquote_plus(k),
                                       urllib.parse.unquote_plus(v)])

    def js_get(self, name):
        def set_(k, v):
            k, v = js_str(k), js_str(v)
            for p in self.pairs:
                if p[0] == k:
                    p[1] = v
                    return
            self.pairs.append([k, v])

        def get(k):
            for p in self.pairs:
                if p[0] == js_str(k):
                    return p[1]
            return NULL

        table = {
            "set": set_, "append": lambda k, v: self.pairs.append([js_str(k), js_str(v)]),
            "get": get, "has": lambda k: any(p[0] == js_str(k) for p in self.pairs),
            "delete": lambda k: self.pairs.__setitem__(
                slice(None), [p for p in self.pairs if p[0] != js_str(k)]),
            "toString": self.to_string,
        }
        return table.get(name, UNDEF)

    def js_set(self, name, value):
        pass

    def to_string(self):
        return "&".join(f"{urllib.parse.quote_plus(k)}={urllib.parse.quote_plus(v)}"
                        for k, v in self.pairs)

    def js_str(self):
        return self.to_string()


class URLObj:
    def __init__(self, href, base=UNDEF):
        href = js_str(href)
        p = urllib.parse.urlparse(href)
        if not p.scheme or not p.netloc:
            throw_error(f"Invalid URL: {href}")
        self.p = p
        self.href = href

    def js_get(self, name):
        table = {
            "host": self.p.netloc,
            "hostname": self.p.hostname or "",
            "protocol": self.p.scheme + ":",
            "pathname": self.p.path or "/",
            "search": ("?" + self.p.query) if self.p.query else "",
            "href": self.href,
            "origin": f"{self.p.scheme}://{self.p.netloc}",
        }
        return table.get(name, UNDEF)

    def js_set(self, name, value):
        pass


class FakeFile:
    def __init__(self, name, data: bytes, mime="application/octet-stream"):
        self.name_, self.data, self.mime = name, data, mime

    def js_get(self, name):
        if name == "name":
            return self.name_
        if name == "size":
            return float(len(self.data))
        if name == "type":
            return self.mime
        if name == "slice":
            def slc(a=UNDEF, b=UNDEF):
                i = 0 if a is UNDEF else int(js_num(a))
                j = len(self.data) if b is UNDEF else int(js_num(b))
                return FakeFile(self.name_, self.data[i:j], self.mime)
            return slc
        return UNDEF

    def js_set(self, name, value):
        pass


class FileReaderObj:
    def __init__(self, browser):
        self.browser = browser
        self.props = {"result": NULL}

    def js_get(self, name):
        if name == "readAsDataURL":
            def read(file):
                data = file.data if isinstance(file, FakeFile) else b""
                mime = file.mime if isinstance(file, FakeFile) else "application/octet-stream"
                self.props["result"] = f"data:{mime};base64," + \
                    base64.b64encode(data).decode()
                cb = self.props.get("onload")
                if cb:
                    self.browser.interp.call(cb, self, [JSObject({"target": self})])
            return read
        return self.props.get(name, UNDEF)

    def js_set(self, name, value):
        self.props[name] = value


class HlsInstance:
    def __init__(self, browser, config=UNDEF):
        self.browser = browser
        self.config = config
        self.source = None
        self.media = None
        self.handlers = {}
        self.destroyed = False
        browser.hls_instances.append(self)

    def js_get(self, name):
        if name == "loadSource":
            def ls(url):
                self.source = js_str(url)
                self.browser.hls_loads.append(js_str(url))
            return ls
        if name == "attachMedia":
            def am(video):
                self.media = video
            return am
        if name == "on":
            def on(ev, cb):
                self.handlers.setdefault(js_str(ev), []).append(cb)
            return on
        if name == "destroy":
            def destroy():
                self.destroyed = True
            return destroy
        return UNDEF

    def js_set(self, name, value):
        pass

    def emit(self, ev, data=None):
        for cb in self.handlers.get(ev, []):
            self.browser.interp.call(cb, UNDEF, [ev, to_js(data) if data
                                                 is not None else JSObject()])


class HlsGlobal:
    MANIFEST_PARSED = "hlsManifestParsed"
    ERROR = "hlsError"

    def __init__(self, browser):
        self.browser = browser

    def js_get(self, name):
        if name == "isSupported":
            return lambda: self.browser.hls_supported
        if name == "Events":
            return JSObject({"MANIFEST_PARSED": self.MANIFEST_PARSED,
                             "ERROR": self.ERROR})
        return UNDEF

    def js_set(self, name, value):
        pass

    def js_construct(self, config=UNDEF):
        return HlsInstance(self.browser, config)


class WindowObj:
    """`window` proxies the global scope (browsers' named global access)."""

    def __init__(self, browser):
        self.browser = browser

    def js_get(self, name):
        g = self.browser.genv
        if g.has(name):
            return g.lookup(name)
        return UNDEF

    def js_set(self, name, value):
        self.browser.genv.assign(name, value)


class _BrowserGlobalEnv(GlobalEnv):
    """Global scope with browser named-element access: an undeclared
    identifier that matches an element id resolves to that element
    (`dlgAddCam.showModal()` in the pages relies on this, as real browsers
    provide)."""

    def __init__(self, browser):
        super().__init__()
        self.browser = browser

    def lookup_missing(self, name):
        el = self.browser.document.get_element_by_id(name)
        if el is not None:
            return el
        throw_error(f"{name} is not defined")

    def has_missing(self, name):
        return self.browser.document.get_element_by_id(name) is not None


# --------------------------------------------------------------------------
# fetch plumbing
# --------------------------------------------------------------------------

class Response:
    def __init__(self, status, body):
        self.status = status
        self.body = body  # str or bytes

    def js_get(self, name):
        if name == "ok":
            return 200 <= self.status < 300
        if name == "status":
            return float(self.status)
        if name == "json":
            def json():
                try:
                    text = self.body.decode() if isinstance(self.body, bytes) else self.body
                    return JSPromise(to_js(_json.loads(text)))
                except Exception:
                    return JSPromise(error=JSThrow(JSObject({"message": "bad json"})))
            return json
        if name == "text":
            text = self.body.decode() if isinstance(self.body, bytes) else self.body
            return lambda: JSPromise(text)
        return UNDEF

    def js_set(self, name, value):
        pass


def live_fetch(base_url):
    """Fetch handler that proxies to a real HTTP server (the product)."""
    def handler(method, url, body):
        data = body.encode() if isinstance(body, str) else body
        req = urllib.request.Request(base_url + url, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
    return handler


# --------------------------------------------------------------------------
# the browser
# --------------------------------------------------------------------------

class Browser:
    """Load an HTML page and execute its inline scripts.

    fetch: handler(method, url, body_str_or_bytes) -> (status, payload)
           where payload is str/bytes (JSON text for .json()).
    hls:   whether the CDN hls.js "loaded" (False simulates air-gap).
    """

    def __init__(self, html_text, fetch=None, hls=False, now_ms=1755600000000.0,
                 url="/", can_play_native=None, confirm=True, prompt=None):
        self.fetch_handler = fetch or (lambda m, u, b: (404, "{}"))
        self.hls_supported = hls
        self.now_ms = float(now_ms)
        self.can_play_native = can_play_native or {}
        self.confirm_response = confirm
        self.prompt_response = prompt
        # recorders
        self.navigations = []
        self.modals = []
        self.alerts = []
        self.confirms = []
        self.prompts = []
        self.console = []
        self.loads = []  # (element, src) every src= assignment
        self.seeks = []
        self.played = []
        self.scrolled_to = []
        self.hls_instances = []
        self.hls_loads = []
        self.fetches = []  # (method, url, body)
        self.timers = {}  # id -> (kind, fn, ms)
        self._timer_seq = [0]
        self.title = ""
        self.focused = None

        self.document = Document(self)
        self.genv = _BrowserGlobalEnv(self)
        self.interp = Interpreter(self.genv)

        p = _FragmentParser(self.document)
        p.feed(html_text)
        p.close()
        for c in p.root.children:
            self.document.root.append(c)
        self._scripts = [(el, src) for el, src in p.scripts
                         if "src" not in el.attrs]

        self.location = Location(self, url)
        self._install_globals()
        for _el, src in self._scripts:  # a load-time JSThrow propagates:
            self.interp.run(es.parse(src), self.genv)  # callers want loud

    # -- globals ---------------------------------------------------------------
    def _install_globals(self):
        g = self.genv
        interp = self.interp
        import math as _math

        def _math_table():
            def rnd(x):
                f = js_num(x)
                return float(_math.floor(f + 0.5)) if not _math.isnan(f) else f
            return _Table({
                "floor": lambda x: float(_math.floor(js_num(x))) if _math.isfinite(js_num(x)) else js_num(x),
                "ceil": lambda x: float(_math.ceil(js_num(x))) if _math.isfinite(js_num(x)) else js_num(x),
                "round": rnd,
                "abs": lambda x: abs(js_num(x)),
                "max": lambda *xs: max((js_num(x) for x in xs), default=float("-inf")),
                "min": lambda *xs: min((js_num(x) for x in xs), default=float("inf")),
                "sqrt": lambda x: _math.sqrt(js_num(x)) if js_num(x) >= 0 else float("nan"),
                "pow": lambda a, b: js_num(a) ** js_num(b),
                "random": lambda: 0.5,  # deterministic for tests
                "hypot": lambda *xs: _math.hypot(*(js_num(x) for x in xs)),
                "PI": _math.pi,
            })

        def parse_int(s, radix=UNDEF):
            t = js_str(s).strip()
            r = int(js_num(radix)) if radix is not UNDEF else 10
            m = _re.match(r"[+-]?(0[xX][0-9a-fA-F]+|\d+)" if r == 10 else
                          rf"[+-]?[0-9a-zA-Z]+", t)
            if not m:
                return float("nan")
            tok = m.group(0)
            try:
                if tok.lower().startswith(("0x", "-0x", "+0x")):
                    return float(int(tok, 16))
                return float(int(tok, r))
            except ValueError:
                return float("nan")

        def parse_float(s):
            m = _re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", js_str(s).strip())
            return float(m.group(0)) if m else float("nan")

        def set_timer(kind):
            def setter(fn, ms=UNDEF, *extra):
                self._timer_seq[0] += 1
                tid = self._timer_seq[0]
                self.timers[tid] = (kind, fn, js_num(ms) if ms is not UNDEF else 0.0)
                return float(tid)
            return setter

        def clear_timer(tid=UNDEF):
            if tid is not UNDEF:
                self.timers.pop(int(js_num(tid)), None)

        def fetch(url, opts=UNDEF):
            method, body = "GET", None
            if isinstance(opts, JSObject):
                if truthy(opts.props.get("method", UNDEF)):
                    method = js_str(opts.props["method"]).upper()
                b = opts.props.get("body", UNDEF)
                if b is not UNDEF:
                    body = b.data if isinstance(b, FakeFile) else js_str(b)
            u = js_str(url)
            self.fetches.append((method, u, body))
            try:
                status, payload = self.fetch_handler(method, u, body)
            except Exception as exc:  # network failure -> rejected promise
                return JSPromise(error=JSThrow(JSObject({"message": str(exc)})))
            return JSPromise(Response(int(status), payload))

        def _alert(msg=UNDEF):
            self.alerts.append(js_str(msg))

        def _confirm(msg=UNDEF):
            self.confirms.append(js_str(msg))
            return self.confirm_response

        def _prompt(msg=UNDEF, dflt=UNDEF):
            self.prompts.append(js_str(msg))
            return NULL if self.prompt_response is None else self.prompt_response

        console = _Table({
            "log": lambda *a: self.console.append(("log", [js_str(x) for x in a])),
            "warn": lambda *a: self.console.append(("warn", [js_str(x) for x in a])),
            "error": lambda *a: self.console.append(("error", [js_str(x) for x in a])),
        })

        date_global = _Table(
            {"now": lambda: self.now_ms},
            construct=lambda *a: JSDate(js_num(a[0]) if a else self.now_ms))

        json_global = _Table({
            "stringify": lambda v, *rest: json_stringify(
                v, indent=int(js_num(rest[1])) if len(rest) > 1 and rest[1] is not UNDEF else None),
            "parse": lambda s: json_parse(js_str(s)),
        })

        object_global = _Table({
            "keys": lambda o: JSArray(list(o.props.keys())) if hasattr(o, "props") else JSArray([]),
            "values": lambda o: JSArray(list(o.props.values())) if hasattr(o, "props") else JSArray([]),
            "entries": lambda o: JSArray([JSArray([k, v]) for k, v in o.props.items()])
            if hasattr(o, "props") else JSArray([]),
            "assign": lambda t, *srcs: (
                [t.props.update(s.props) for s in srcs if hasattr(s, "props")], t)[1],
            "fromEntries": lambda pairs: JSObject(
                {js_str(p.items[0]): p.items[1] for p in pairs.items}),
        })

        array_global = _Table({
            "isArray": lambda v=UNDEF: isinstance(v, JSArray),
            "from": lambda v=UNDEF, fn=UNDEF: JSArray(
                [interp.call(fn, UNDEF, [x, float(i)]) if fn is not UNDEF else x
                 for i, x in enumerate(js_iter(v))]),
        })

        promise_global = _Table({
            "resolve": lambda v=UNDEF: v if isinstance(v, JSPromise) else JSPromise(v),
            "all": lambda arr: JSPromise(JSArray(
                [(x.value if isinstance(x, JSPromise) else x) for x in arr.items])),
        }, construct=self._promise_ctor)

        def option_ctor(text=UNDEF, value=UNDEF):
            el = Element("option", self.document)
            if text is not UNDEF:
                el.children.append(js_str(text))
            if value is not UNDEF:
                el.attrs["value"] = js_str(value)
            return el

        for name, val in {
            "document": self.document,
            "window": WindowObj(self),
            "location": None,  # installed below with hook
            "console": console,
            "Math": _math_table(),
            "JSON": json_global,
            "Object": object_global,
            "Array": array_global,
            "Promise": promise_global,
            "Date": date_global,
            "String": lambda v=UNDEF: js_str(v) if v is not UNDEF else "",
            "Number": lambda v=UNDEF: js_num(v) if v is not UNDEF else 0.0,
            "Boolean": lambda v=UNDEF: truthy(v),
            "parseInt": parse_int,
            "parseFloat": parse_float,
            "isNaN": lambda v=UNDEF: _math.isnan(js_num(v)),
            "isFinite": lambda v=UNDEF: _math.isfinite(js_num(v)),
            "NaN": float("nan"),
            "Infinity": float("inf"),
            "encodeURIComponent": lambda s=UNDEF: urllib.parse.quote(
                js_str(s), safe="!'()*-._~"),
            "decodeURIComponent": lambda s=UNDEF: urllib.parse.unquote(js_str(s)),
            "encodeURI": lambda s=UNDEF: urllib.parse.quote(js_str(s), safe=";/?:@&=+$,#!'()*-._~"),
            "setTimeout": set_timer("timeout"),
            "setInterval": set_timer("interval"),
            "clearTimeout": clear_timer,
            "clearInterval": clear_timer,
            "fetch": fetch,
            "alert": _alert,
            "confirm": _confirm,
            "prompt": _prompt,
            "URLSearchParams": _Table({}, construct=lambda init=UNDEF: URLSearchParamsObj(init)),
            "URL": _Table({}, construct=URLObj),
            "FileReader": _Table({}, construct=lambda: FileReaderObj(self)),
            "Option": _Table({}, construct=option_ctor),
            "navigator": JSObject({"userAgent": "clearcam-jsengine"}),
        }.items():
            if val is not None:
                g.declare(name, val)

        g.declare("location", self.location)
        g.assign_hooks["location"] = self._location_hook
        if self.hls_supported:
            g.declare("Hls", HlsGlobal(self))

    def _location_hook(self, value):
        if isinstance(value, str):
            self.location.navigate(value)
            return True
        return False

    def _promise_ctor(self, executor=UNDEF):
        box = {"v": UNDEF, "e": None}

        def resolve(v=UNDEF):
            box["v"] = v

        def reject(e=UNDEF):
            box["e"] = JSThrow(e)
        if executor is not UNDEF:
            self.interp.call(executor, UNDEF, [resolve, reject])
        return JSPromise(box["v"], box["e"])

    # -- test-harness API -------------------------------------------------------
    def el(self, id_) -> Element:
        e = self.document.get_element_by_id(id_)
        if e is None:
            raise KeyError(f"no element #{id_}")
        return e

    def call(self, name, *args):
        """Call a global JS function with Python/JS args; returns the JS value
        (unwrapping a settled promise)."""
        fn = self.genv.lookup(name)
        out = self.interp.call(fn, UNDEF, [to_js(a) if isinstance(a, (dict, list))
                                           else (float(a) if isinstance(a, (int,)) and not isinstance(a, bool) else a)
                                           for a in args])
        if isinstance(out, JSPromise):
            if out.error is not None:
                raise out.error
            return out.value
        return out

    def get(self, name):
        return self.genv.lookup(name)

    def click(self, target, **props):
        el = target if isinstance(target, Element) else self.el(target)
        return el.dispatch("click", clientX=0.0, clientY=0.0, **props)

    def fire_timers(self, kind=None, max_fires=None):
        """Run pending timers once each (intervals stay registered)."""
        fired = 0
        for tid, (k, fn, ms) in list(self.timers.items()):
            if kind is not None and k != kind:
                continue
            if k == "timeout":
                self.timers.pop(tid, None)
            self.interp.call(fn, UNDEF, [])
            fired += 1
            if max_fires is not None and fired >= max_fires:
                break
        return fired

    def run_script(self, src):
        return self.interp.run(es.parse(src), self.genv)

    def eval(self, src):
        from .es import parse_expression
        v = self.interp.eval(parse_expression(src), self.genv)
        if isinstance(v, JSPromise):
            if v.error is not None:
                raise v.error
            return v.value
        return v
