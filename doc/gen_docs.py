"""API documentation generator for runlmc_tpu.

The reference ships a sphinx apidoc build (reference doc/conf.py +
docbuild.sh). This environment has no sphinx, so the docs layer is a
small self-contained generator: it walks the package with ``inspect``,
renders every module / class / function docstring into one static HTML
page per module plus an index, and cross-links ``module.name`` mentions.
Run via ``./docbuild.sh`` (output in ``doc/_build/``).
"""

import html
import importlib
import inspect
import os
import pkgutil
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

STYLE = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       max-width: 60rem; margin: 2rem auto; padding: 0 1rem;
       color: #1a1a1a; line-height: 1.5; }
pre { background: #f6f6f4; padding: .75rem 1rem; overflow-x: auto;
      border-radius: 6px; font-size: .85rem; line-height: 1.45; }
code { background: #f6f6f4; padding: .1em .3em; border-radius: 3px;
       font-size: .9em; }
h1 { border-bottom: 2px solid #e5e5e2; padding-bottom: .3rem; }
h2 { margin-top: 2.2rem; border-bottom: 1px solid #e5e5e2;
     padding-bottom: .2rem; }
h3 { margin-top: 1.6rem; }
.sig { background: #eef2f7; padding: .5rem .8rem; border-radius: 6px;
       font-family: ui-monospace, monospace; font-size: .85rem;
       white-space: pre-wrap; }
.kind { color: #8a6d00; font-size: .75rem; text-transform: uppercase;
        letter-spacing: .05em; }
nav a { margin-right: 1rem; }
a { color: #1f6feb; text-decoration: none; }
a:hover { text-decoration: underline; }
"""


def _doc(obj):
    d = inspect.getdoc(obj)
    return html.escape(d) if d else ""


def _sig(obj):
    try:
        return html.escape(str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def iter_modules(pkg):
    yield pkg.__name__
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        yield info.name


def render_module(name):
    mod = importlib.import_module(name)
    parts = ["<h1><span class=kind>module</span> %s</h1>" % name]
    parts.append("<pre>%s</pre>" % _doc(mod))

    members = inspect.getmembers(mod)
    classes = [
        (n, o) for n, o in members
        if inspect.isclass(o) and getattr(o, "__module__", "") == name
    ]
    funcs = [
        (n, o) for n, o in members
        if inspect.isfunction(o) and getattr(o, "__module__", "") == name
    ]
    for n, cls in classes:
        parts.append(
            "<h2 id='%s'><span class=kind>class</span> %s</h2>" % (n, n)
        )
        parts.append("<div class=sig>class %s%s</div>" % (n, _sig(cls)))
        if inspect.getdoc(cls):
            parts.append("<pre>%s</pre>" % _doc(cls))
        for mn, m in inspect.getmembers(cls, inspect.isfunction):
            if mn.startswith("_") and mn != "__init__":
                continue
            if m.__qualname__.split(".")[0] != n:
                continue  # inherited
            parts.append("<h3>%s.%s</h3>" % (n, mn))
            parts.append("<div class=sig>%s%s</div>" % (mn, _sig(m)))
            if inspect.getdoc(m):
                parts.append("<pre>%s</pre>" % _doc(m))
    for n, fn in funcs:
        if n.startswith("_"):
            continue
        parts.append(
            "<h2 id='%s'><span class=kind>def</span> %s</h2>" % (n, n)
        )
        parts.append("<div class=sig>%s%s</div>" % (n, _sig(fn)))
        if inspect.getdoc(fn):
            parts.append("<pre>%s</pre>" % _doc(fn))
    return "\n".join(parts)


def page(title, body, depth=0):
    home = "../" * depth + "index.html"
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>%s</title><style>%s</style></head><body>"
        "<nav><a href='%s'>runlmc_tpu API index</a></nav>%s"
        "</body></html>" % (html.escape(title), STYLE, home, body)
    )


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import runlmc_tpu

    os.makedirs(OUT, exist_ok=True)
    names = sorted(set(iter_modules(runlmc_tpu)))
    index_rows = []
    for name in names:
        try:
            body = render_module(name)
        except Exception as e:  # pragma: no cover - report and continue
            print("SKIP %s: %r" % (name, e), file=sys.stderr)
            continue
        fn = name.replace(".", "_") + ".html"
        with open(os.path.join(OUT, fn), "w") as f:
            f.write(page(name, body))
        mod = importlib.import_module(name)
        first = (inspect.getdoc(mod) or "").split("\n")[0]
        index_rows.append(
            "<li><a href='%s'><code>%s</code></a> — %s</li>"
            % (fn, name, html.escape(first))
        )
    body = (
        "<h1>runlmc_tpu — API documentation</h1>"
        "<p>Multi-output GP framework (SKI LMC) on JAX. Generated "
        "from module docstrings by <code>doc/gen_docs.py</code>; the "
        "analog of the reference's sphinx apidoc build "
        "(reference doc/conf.py, docbuild.sh).</p><ul>%s</ul>"
        % "\n".join(index_rows)
    )
    with open(os.path.join(OUT, "index.html"), "w") as f:
        f.write(page("runlmc_tpu API", body))
    print("wrote %d module pages to %s" % (len(index_rows), OUT))


if __name__ == "__main__":
    main()
