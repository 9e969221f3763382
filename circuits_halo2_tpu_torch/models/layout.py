"""Circuit layout rendering — the dev-graph equivalent.

The reference renders the MstInclusion layout with plotters behind the
``dev-graph`` feature (`zk_prover/src/circuits/tests.rs:435-459`,
``CircuitLayout::default().render(k, &circuit, &root)``). This module
renders the same information from an ``Assignment``'s region log to a
dependency-free SVG (columns × rows, one colored band per region per
column) plus a text table, so circuit authors can see row occupancy and
region packing without leaving the framework.
"""

from __future__ import annotations

from .assignment import Assignment

_PALETTE = [
    "#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2",
    "#eeca3b", "#b279a2", "#ff9da6", "#9d755d", "#bab0ac",
]


def _column_order(asn: Assignment) -> list:
    """Stable x-axis: advice, fixed, instance columns, then selectors."""
    cs = asn.cs
    cols: list = []
    seen = set()
    for key in asn.columns:
        if isinstance(key, tuple) and key and key[0] == "selector":
            continue
        if key not in seen:
            seen.add(key)
            cols.append(key)
    cols.sort(key=repr)
    selectors = [("selector", i) for i in range(cs.num_selectors)]
    return cols + selectors


def layout_table(asn: Assignment) -> str:
    """Region table: name, start row, height, column count."""
    lines = [f"{'region':40s} {'start':>7s} {'rows':>6s} {'cols':>5s}"]
    for name, start, height, used in asn.regions_log:
        lines.append(f"{name[:40]:40s} {start:7d} {height:6d} {len(used):5d}")
    total = max(
        (start + height for _, start, height, _ in asn.regions_log), default=0
    )
    lines.append(
        f"-- {len(asn.regions_log)} regions, {total} rows used of "
        f"{asn.usable_rows} usable ({asn.n} total)"
    )
    return "\n".join(lines)


def render_layout_svg(asn: Assignment, max_rows: int | None = None) -> str:
    """SVG of the region layout (reference CircuitLayout analogue)."""
    cols = _column_order(asn)
    col_x = {key: i for i, key in enumerate(cols)}
    used_rows = max(
        (start + height for _, start, height, _ in asn.regions_log), default=1
    )
    rows = min(used_rows, max_rows) if max_rows else used_rows

    cw, rh, legend_h = 18, 2, 16
    width = cw * len(cols) + 220
    height = rh * rows + legend_h * (len(asn.regions_log) + 2) + 30
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="10">',
        f'<rect width="{cw * len(cols)}" height="{rh * rows}" fill="#f5f5f5"/>',
    ]
    for name_i, (name, start, h, used) in enumerate(asn.regions_log):
        if start >= rows:
            continue
        color = _PALETTE[name_i % len(_PALETTE)]
        for key in used:
            if isinstance(key, tuple) and key and key[0] == "selector":
                x = col_x.get(key)
            else:
                x = col_x.get(key)
            if x is None:
                continue
            out.append(
                f'<rect x="{x * cw}" y="{start * rh}" width="{cw - 1}" '
                f'height="{min(h, rows - start) * rh}" fill="{color}" '
                f'fill-opacity="0.75"><title>{name} '
                f'[{start}..{start + h})</title></rect>'
            )
    # legend
    y0 = rh * rows + 12
    out.append(
        f'<text x="0" y="{y0}">{len(asn.regions_log)} regions, '
        f"{used_rows}/{asn.usable_rows} usable rows, "
        f"{len(cols)} columns</text>"
    )
    seen_names: list[str] = []
    for name_i, (name, start, h, _) in enumerate(asn.regions_log):
        if name in seen_names:
            continue
        seen_names.append(name)
        y = y0 + legend_h * len(seen_names)
        color = _PALETTE[name_i % len(_PALETTE)]
        out.append(f'<rect x="0" y="{y - 9}" width="10" height="10" fill="{color}"/>')
        out.append(f'<text x="14" y="{y}">{name}</text>')
    out.append("</svg>")
    return "\n".join(out)


def render_layout(asn: Assignment, path: str) -> None:
    """Write the SVG layout to ``path`` (reference writes a PNG via
    plotters; SVG needs no native raster dependency)."""
    with open(path, "w") as f:
        f.write(render_layout_svg(asn))
