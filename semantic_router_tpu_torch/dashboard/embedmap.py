"""The embedding map: a 2-D view of an embedding population for the
dashboard (``/dashboard/api/embedmap`` and the canvas page
``/dashboard/embedmap``).

``project_2d`` is numpy PCA on the host (center, SVD, the top two
components, each axis scaled to [-1, 1]) over vectors brought to the host
once — the signs of the components are numpy's, as in the reference
package.  ``build_map`` adds a density grid and, per occupied cell, the
tokens of highest lift (``_cell_labels``).  ``render_page`` is a
self-contained HTML canvas page that ships no data: its source list and
its points come from the gated API.  Sources are (text, vector) pairs:
the semantic cache's entries, the memory store's items, a vector store's
chunks.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_WORD = re.compile(r"[A-Za-z][A-Za-z0-9_]{2,}")
_STOP = {"the", "and", "for", "with", "that", "this", "from", "are",
         "was", "has", "have", "about", "into", "over", "under", "its",
         "per", "not", "all", "any", "can", "how", "what", "when",
         "where", "which", "who", "why", "you", "your"}


def project_2d(vectors: np.ndarray) -> np.ndarray:
    """Center + SVD top-2 components, scaled to [-1, 1] per axis."""
    x = np.asarray(vectors, np.float32)
    if x.ndim != 2 or x.shape[0] == 0:
        return np.zeros((0, 2), np.float32)
    if x.shape[0] == 1:
        return np.zeros((1, 2), np.float32)
    x = x - x.mean(axis=0, keepdims=True)
    # SVD of [N, D]: right vectors give the principal directions
    try:
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        coords = x @ vt[:2].T
    except np.linalg.LinAlgError:
        coords = x[:, :2] if x.shape[1] >= 2 else \
            np.pad(x, ((0, 0), (0, 2 - x.shape[1])))
    span = np.abs(coords).max(axis=0)
    span[span == 0] = 1.0
    return (coords / span).astype(np.float32)


def _cell_labels(texts: Sequence[str], cells: Sequence[int],
                 n_cells: int, top: int = 3) -> Dict[int, List[str]]:
    """Highest-lift tokens per occupied cell: score = cell tf × log of
    inverse corpus frequency (distinctive, not merely common)."""
    corpus: Dict[str, int] = {}
    per_cell: Dict[int, Dict[str, int]] = {}
    for text, cell in zip(texts, cells):
        seen = set()
        for w in _WORD.findall(text.lower()):
            if w in _STOP:
                continue
            if w not in seen:
                corpus[w] = corpus.get(w, 0) + 1
                seen.add(w)
            per_cell.setdefault(cell, {})[w] = \
                per_cell.get(cell, {}).get(w, 0) + 1
    total_docs = max(len(texts), 1)
    out: Dict[int, List[str]] = {}
    for cell, counts in per_cell.items():
        scored = sorted(
            counts.items(),
            key=lambda kv: -kv[1] * float(np.log(
                1.0 + total_docs / corpus.get(kv[0], 1))))
        out[cell] = [w for w, _ in scored[:top]]
    return out


def build_map(items: Iterable[Tuple[str, Optional[np.ndarray]]],
              grid: int = 12, max_points: int = 5000) -> Dict:
    """The map of ``items`` ((text, vector or None)): points [[x, y]...],
    labels, the density grid and each occupied cell's region labels.
    Items without a finite vector are dropped and counted; vectors of
    several widths (Matryoshka cuts) are zero-padded to the widest."""
    texts: List[str] = []
    vecs: List[np.ndarray] = []
    dropped = 0
    for text, vec in items:
        if vec is None:
            dropped += 1
            continue
        v = np.asarray(vec, np.float32).reshape(-1)
        if v.size == 0 or not np.isfinite(v).all():
            dropped += 1
            continue
        texts.append(text)
        vecs.append(v)
        if len(vecs) >= max_points:
            break
    if not vecs:
        return {"points": [], "labels": [], "density": [],
                "regions": {}, "grid": grid, "dropped": dropped}
    dim = max(v.size for v in vecs)
    mat = np.zeros((len(vecs), dim), np.float32)
    for i, v in enumerate(vecs):
        mat[i, :v.size] = v
    coords = project_2d(mat)

    # density + cell assignment on a grid×grid lattice over [-1, 1]²
    idx = np.clip(((coords + 1.0) / 2.0 * grid).astype(int), 0,
                  grid - 1)
    cells = (idx[:, 1] * grid + idx[:, 0]).tolist()
    density = np.zeros((grid, grid), np.int32)
    for gx, gy in idx:
        density[gy, gx] += 1
    regions = _cell_labels(texts, cells, grid * grid)

    return {
        "points": [[round(float(x), 4), round(float(y), 4)]
                   for x, y in coords],
        "labels": [t[:120] for t in texts],
        "density": density.tolist(),
        "regions": {str(c): words for c, words in sorted(regions.items())},
        "grid": grid,
        "dropped": dropped,
    }


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Embedding map</title>
<style>
 body {{ font: 13px system-ui, sans-serif; margin: 0; background: #10141a;
        color: #d7dde6; }}
 header {{ padding: 10px 16px; display: flex; gap: 12px;
          align-items: center; }}
 select {{ background: #1a212b; color: inherit; border: 1px solid #2c3642;
          padding: 4px 8px; border-radius: 4px; }}
 #wrap {{ position: relative; margin: 0 16px; }}
 canvas {{ background: #141a22; border: 1px solid #2c3642;
          border-radius: 6px; width: 100%; }}
 #tip {{ position: absolute; pointer-events: none; background: #000c;
        padding: 4px 8px; border-radius: 4px; max-width: 340px;
        display: none; }}
 .muted {{ color: #76828f; }}
</style></head>
<body>
<header><strong>Embedding map</strong>
 <select id="src">{options}</select>
 <input id="apikey" type="password" placeholder="API key"
        style="background:#1a212b;color:inherit;border:1px solid #2c3642;
               padding:4px 8px;border-radius:4px">
 <span id="meta" class="muted"></span></header>
<div id="wrap"><canvas id="c" width="960" height="640"></canvas>
<div id="tip"></div></div>
<script>
const cv = document.getElementById('c'), cx = cv.getContext('2d');
const tip = document.getElementById('tip');
let data = null;
function px(p) {{ return [(p[0] + 1) / 2 * cv.width,
                         (1 - (p[1] + 1) / 2) * cv.height]; }}
function draw() {{
  cx.clearRect(0, 0, cv.width, cv.height);
  if (!data || !data.points.length) {{
    cx.fillStyle = '#76828f'; cx.fillText('no embedded items', 20, 30);
    return;
  }}
  const g = data.grid, cw = cv.width / g, ch = cv.height / g;
  const dmax = Math.max(1, ...data.density.flat());
  for (let y = 0; y < g; y++) for (let x = 0; x < g; x++) {{
    const d = data.density[y][x];
    if (!d) continue;
    cx.fillStyle = `rgba(64,140,255,${{0.06 + 0.25 * d / dmax}})`;
    cx.fillRect(x * cw, cv.height - (y + 1) * ch, cw, ch);
  }}
  cx.fillStyle = '#9ec1ff';
  for (const p of data.points) {{
    const [x, y] = px(p);
    cx.beginPath(); cx.arc(x, y, 2.5, 0, 7); cx.fill();
  }}
  cx.fillStyle = '#c8d2de'; cx.font = '11px system-ui';
  for (const [cell, words] of Object.entries(data.regions)) {{
    const c = +cell, gx = c % g, gy = (c - gx) / g;
    const d = data.density[gy][gx];
    if (d < 2) continue;
    cx.fillText(words.join(' · '), gx * cw + 4,
                cv.height - gy * ch - ch + 14);
  }}
}}
cv.onmousemove = (e) => {{
  if (!data) return;
  const r = cv.getBoundingClientRect();
  const mx = (e.clientX - r.left) * cv.width / r.width;
  const my = (e.clientY - r.top) * cv.height / r.height;
  let best = -1, bd = 144;
  data.points.forEach((p, i) => {{
    const [x, y] = px(p), d = (x - mx) ** 2 + (y - my) ** 2;
    if (d < bd) {{ bd = d; best = i; }}
  }});
  if (best >= 0) {{
    tip.style.display = 'block';
    tip.style.left = (e.clientX - r.left + 12) + 'px';
    tip.style.top = (e.clientY - r.top + 12) + 'px';
    tip.textContent = data.labels[best];
  }} else tip.style.display = 'none';
}};
function authHeaders() {{
  // same credential convention as the bundled dashboard page: key typed
  // once, kept in sessionStorage, sent as x-api-key
  const keyEl = document.getElementById('apikey');
  const key = keyEl.value || sessionStorage.getItem('srt-key') || '';
  if (keyEl.value) sessionStorage.setItem('srt-key', key);
  return key ? {{'x-api-key': key}} : {{}};
}}
async function loadSources() {{
  // the page ships with an EMPTY dropdown — store names are data and
  // stay behind the same auth gate as the vectors themselves
  const resp = await fetch('/dashboard/api/embedmap/sources',
                           {{headers: authHeaders()}});
  if (!resp.ok) {{
    document.getElementById('meta').textContent =
      resp.status === 401 || resp.status === 403 ?
        'enter API key to list sources' : ('HTTP ' + resp.status);
    return false;
  }}
  const body = await resp.json();
  const sel = document.getElementById('src'), prev = sel.value;
  sel.innerHTML = '';
  for (const s of (body.sources || [])) {{
    const o = document.createElement('option');
    o.value = s; o.textContent = s; sel.appendChild(o);
  }}
  if (prev) sel.value = prev;
  return true;
}}
async function load() {{
  const src = document.getElementById('src').value;
  if (!src) {{ if (!(await loadSources())) return; }}
  const resp = await fetch('/dashboard/api/embedmap?source=' +
      encodeURIComponent(document.getElementById('src').value || 'cache'),
      {{headers: authHeaders()}});
  let body = null;
  try {{ body = await resp.json(); }} catch (e) {{ body = null; }}
  if (!resp.ok || !body || !body.points) {{
    data = null; draw();
    document.getElementById('meta').textContent =
      (body && body.error) || ('HTTP ' + resp.status);
    return;
  }}
  data = body;
  document.getElementById('meta').textContent =
    data.points.length + ' points' +
    (data.dropped ? ` (${{data.dropped}} without vectors)` : '');
  draw();
}}
document.getElementById('src').onchange = load;
document.getElementById('apikey').onchange =
  async () => {{ if (await loadSources()) load(); }};
(async () => {{ if (await loadSources()) load(); }})();
</script></body></html>
"""


def render_page(sources: Sequence[str] = ()) -> str:
    """The page, its source list empty: store names are data and arrive
    from the gated ``/dashboard/api/embedmap/sources`` (inserted as DOM
    ``textContent``, so a hostile name cannot become markup).
    ``sources`` is ignored, as the reference package's is."""
    return _PAGE.format(options="")
