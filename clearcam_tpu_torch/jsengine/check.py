"""Reusable UI-script checks built on the JS engine.

Shared by tests/test_ui_exec.py and tools/uicheck.py (the deployment
verifier): extract a page's inline scripts + on* handlers, parse them, and
verify every referenced identifier resolves to a declaration, a browser
global, or a DOM id (browsers' named element access).
"""

from __future__ import annotations

import re

from . import es


def extract_scripts_and_handlers(text: str):
    """-> (script_sources, [(tag, attr, source)]) for a full HTML page.

    External scripts (src=) are skipped — only inline code can be checked.
    """
    from .dom import Document, _FragmentParser
    doc = Document.__new__(Document)
    doc.browser = None
    p = _FragmentParser(doc)
    p.feed(text)
    p.close()
    scripts = [src for el, src in p.scripts if "src" not in el.attrs]
    handlers = []
    stack = list(p.root.children)
    while stack:
        el = stack.pop()
        if not hasattr(el, "attrs"):
            continue
        stack.extend(el.children)
        for k, v in el.attrs.items():
            if k.startswith("on") and v:
                handlers.append((el.tag, k, v))
    return scripts, handlers


def browser_global_names() -> set:
    from .dom import Browser
    return set(Browser("<html></html>", hls=True).genv.vars)


def page_problems(text: str) -> list:
    """Parse + scope-check one page; returns human-readable problem strings
    (empty = clean). Raises nothing: syntax errors become problems."""
    problems = []
    try:
        scripts, handlers = extract_scripts_and_handlers(text)
    except Exception as exc:  # malformed HTML
        return [f"html parse failed: {exc}"]
    allowed = browser_global_names() | set(re.findall(r'id="([^"]+)"', text)) \
        | {"event"}
    declared = set()
    asts = []
    for i, src in enumerate(scripts):
        try:
            ast = es.parse(src)
        except es.JSSyntaxError as exc:
            problems.append(f"script[{i}]: {exc}")
            continue
        asts.append((i, ast))
        for s in ast[1]:
            if s[0] == "func":
                declared.add(s[1])
            elif s[0] == "var":
                for pat, _ in s[2]:
                    es._pattern_names(pat, declared)
    for i, ast in asts:
        bad = es.free_identifiers(ast) - allowed - declared
        if bad:
            problems.append(f"script[{i}]: unresolved identifiers {sorted(bad)}")
    for tag, attr, src in handlers:
        try:
            ast = es.parse(src)
        except es.JSSyntaxError as exc:
            problems.append(f"<{tag} {attr}>: {exc}")
            continue
        bad = es.free_identifiers(ast) - allowed - declared
        if bad:
            problems.append(f"<{tag} {attr}>: unresolved identifiers {sorted(bad)}")
    return problems
