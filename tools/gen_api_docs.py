"""Generate a markdown API reference for mfs_tpu from docstrings.

Dependency-free (inspect + importlib): the environment has no Sphinx
or pdoc, so this renders each public module's signatures + docstrings
into ``docs/api/<module>.md`` plus an index.  Re-run after API
changes: ``python tools/gen_api_docs.py``.

Counterpart of the reference's docs tree (``/root/reference/docs``),
which ships only figure assets; this generates the full reference the
README points at.
"""
import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = [
    "mfs_tpu",
    "mfs_tpu.config",
    "mfs_tpu.typings",
    "mfs_tpu.utils.gaussian",
    "mfs_tpu.utils.sdes",
    "mfs_tpu.utils.combinatorics",
    "mfs_tpu.utils.linalg",
    "mfs_tpu.utils.pcrlb",
    "mfs_tpu.utils.profiling",
    "mfs_tpu.one_dim.quadrature",
    "mfs_tpu.one_dim.moments",
    "mfs_tpu.one_dim.filtering",
    "mfs_tpu.one_dim.pdf_approximations",
    "mfs_tpu.multi_dims.multi_indices",
    "mfs_tpu.multi_dims.moments",
    "mfs_tpu.multi_dims.quadrature",
    "mfs_tpu.multi_dims.filtering",
    "mfs_tpu.multi_dims.poly_tme",
    "mfs_tpu.sde.tme",
    "mfs_tpu.sde.transitions",
    "mfs_tpu.filters.gaussian",
    "mfs_tpu.filters.sigma_points",
    "mfs_tpu.filters.smc",
    "mfs_tpu.filters.resampling",
    "mfs_tpu.filters.grid",
    "mfs_tpu.estimation.mle",
    "mfs_tpu.estimation.lbfgs_batched",
    "mfs_tpu.models.one_dim",
    "mfs_tpu.models.multi_dims",
    "mfs_tpu.ops.eigh",
    "mfs_tpu.ops.flops",
    "mfs_tpu.parallel.mesh",
    "mfs_tpu.parallel.ensemble",
]

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "api")


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return f"{indent}*(no docstring)*\n"
    return "\n".join(indent + line for line in d.splitlines()) + "\n"


def render_module(name: str) -> str:
    mod = importlib.import_module(name)
    lines = [f"# `{name}`", ""]
    lines.append(_doc(mod))
    lines.append("")

    members = []
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_"):
            continue
        if inspect.ismodule(obj):
            continue
        defined_here = getattr(obj, "__module__", None) == name
        if not defined_here:
            continue
        members.append((attr, obj))

    funcs = [(a, o) for a, o in members
             if inspect.isfunction(o) or callable(o) and not inspect.isclass(o)]
    classes = [(a, o) for a, o in members if inspect.isclass(o)]

    if classes:
        lines.append("## Classes\n")
        for attr, obj in classes:
            lines.append(f"### `{attr}{_sig(obj) if not issubclass(obj, tuple) else ''}`\n")
            lines.append(_doc(obj))
            for m_name, m in sorted(vars(obj).items()):
                if m_name.startswith("_") or not callable(m):
                    continue
                doc = inspect.getdoc(m)
                if not doc:
                    continue
                lines.append(f"#### `{attr}.{m_name}{_sig(m)}`\n")
                lines.append(_doc(m))
            lines.append("")

    if funcs:
        lines.append("## Functions\n")
        for attr, obj in funcs:
            if not (inspect.isfunction(obj) or hasattr(obj, "__call__")):
                continue
            lines.append(f"### `{attr}{_sig(obj)}`\n")
            lines.append(_doc(obj))
            lines.append("")

    return "\n".join(lines)


def main():
    os.makedirs(OUT, exist_ok=True)
    index = [
        "# mfs_tpu API reference",
        "",
        "Generated by `tools/gen_api_docs.py` from the package "
        "docstrings.  Layer map and design rationale: see the repo "
        "README; reference-parity citations (`path:line` into the "
        "upstream `mfs` repo) live in each docstring.",
        "",
    ]
    for name in MODULES:
        md = render_module(name)
        fname = name.replace(".", "_") + ".md"
        with open(os.path.join(OUT, fname), "w") as f:
            f.write(md)
        mod = importlib.import_module(name)
        first = (inspect.getdoc(mod) or "").split("\n")[0]
        index.append(f"- [`{name}`]({fname}) — {first}")
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(MODULES) + 1} files to {OUT}")


if __name__ == "__main__":
    main()
