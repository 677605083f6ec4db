"""In-repo JavaScript engine for air-gapped frontend verification.

The build hosts (and some deploy targets) have no browser, node, or any JS
runtime, so the web UI's script blocks could historically only be checked
with regex heuristics (brace balance, DOM-id cross references). This
package closes that gap with a clean-room ES2017-subset engine written in
Python:

- ``es``      — lexer + recursive-descent parser producing a tuple AST,
                plus a lexical-scope analyzer (free-identifier detection);
- ``interp``  — tree-walking interpreter with the JS semantics the UI
                relies on (closures, async/await over eagerly-resolved
                promises, loose/strict equality, ToInt32 bit ops, JSON,
                template literals, destructuring, spread, ``??``/``?.``);
- ``dom``     — a fake DOM/browser (document tree built by html.parser,
                innerHTML re-parsing, event bubbling, dialogs, selects,
                canvas 2D recording, timers, fetch routing) and a
                ``Browser`` harness that loads a page and drives it.

The engine targets exactly the language subset the repo's UI uses (see
tests/test_ui_exec.py); it is NOT a general-purpose JS implementation.
Reference behavior mirrored: the reference serves mainview.html
(the reference's clearcam.py:960-988) and never tests it at all — this
gives the rebuilt UI an executable regression surface.
"""

from . import es, interp  # noqa: F401  (dom imported lazily; needs interp)
