"""Key-map overlays: data-only renames of a vendor checkpoint's keys.

Counterpart of ``audiocodecs_tpu/convert/overlay.py``, kept as the port's
own copy (the port imports nothing of the JAX package). Five converters
take ``key_map=`` (StableCodec, MagiCodec, FocalCodec, HILCodec, DyCAST):
their vendors published no state-dict schema that could be pinned offline,
so a real checkpoint may arrive with other names. An overlay makes that a
data-only fix: diff the checkpoint against the documented schema with
``tools/inspect_checkpoint_torch.py <file> --family <name>``, write the
renames into a ``key_map.json``, and convert with ``--key-map``.

Overlay file format (a JSON object; every section optional)::

    {
      "drop":   ["exact.key.to.discard", "prefix.to.discard.*"],
      "rename": {"vendor.exact.key": "schema.exact.key"},
      "prefix": {"vendor.prefix.": "schema.prefix."},
      "regex":  [["vendor\\.layers\\.(\\d+)\\.", "schema.layers.\\1."]]
    }

Order for each source key: ``drop`` (exact, or a prefix ending in ``*``),
then ``rename`` (exact, wins outright), then ``prefix`` (the longest
matching prefix, substituted once), then ``regex`` (each pattern in its
listed order, :func:`re.sub`). Two source keys renamed onto one target
raise: an overlay is injective on the keys it touches.
"""

from __future__ import annotations

import json
import re
from typing import Mapping

__all__ = ["apply_key_map", "load_key_map", "propose_key_map"]

# sections starting with "_" are ignored (comments / unresolved notes from
# propose_key_map)
_SECTIONS = ("drop", "rename", "prefix", "regex")


def load_key_map(path: str) -> dict:
    """Read + validate an overlay JSON file."""
    with open(path) as f:
        key_map = json.load(f)
    if not isinstance(key_map, dict):
        raise ValueError(f"{path}: overlay must be a JSON object")
    unknown = sorted(k for k in set(key_map) - set(_SECTIONS)
                     if not k.startswith("_"))
    if unknown:
        raise ValueError(
            f"{path}: unknown overlay sections {unknown}; "
            f"expected a subset of {list(_SECTIONS)} (\"_*\" sections are "
            "ignored comments)")
    return key_map


def apply_key_map(sd: Mapping, key_map: dict | str | None) -> dict:
    """Return ``sd`` with the overlay's renames applied (values untouched).

    ``key_map`` may be the parsed dict, a path to a JSON file, or None
    (no-op). Raises if two source keys collide on one target, or if an
    exact ``rename``/``drop`` entry matches nothing (a typo'd overlay
    should fail loudly, not silently convert the unrenamed checkpoint —
    prefix/regex rules are allowed to match nothing since one rule often
    covers only some sub-towers).
    """
    if key_map is None:
        return dict(sd)
    if isinstance(key_map, str):
        key_map = load_key_map(key_map)
    drops = list(key_map.get("drop", ()))
    renames = dict(key_map.get("rename", {}))
    prefixes = sorted(key_map.get("prefix", {}).items(),
                      key=lambda kv: -len(kv[0]))
    regexes = [(re.compile(p), r) for p, r in key_map.get("regex", ())]

    exact_drops = {d for d in drops if not d.endswith("*")}
    prefix_drops = tuple(d[:-1] for d in drops if d.endswith("*"))
    missing = sorted(
        {k for k in renames if k not in sd}
        | {d for d in exact_drops if d not in sd})
    if missing:
        raise ValueError(
            f"key_map: {len(missing)} exact rename/drop entries match no "
            f"checkpoint key (typo in the overlay?). First few: "
            f"{missing[:6]}")

    out: dict = {}
    origin: dict = {}
    for k, v in sd.items():
        if k in exact_drops or k.startswith(prefix_drops):
            continue
        if k in renames:
            nk = renames[k]
        else:
            nk = k
            for src, dst in prefixes:
                if nk.startswith(src):
                    nk = dst + nk[len(src):]
                    break
            for pat, repl in regexes:
                nk = pat.sub(repl, nk)
        if nk in out:
            raise ValueError(
                f"key_map: {k!r} and {origin[nk]!r} both map to {nk!r}")
        out[nk] = v
        origin[nk] = k
    return out


def propose_key_map(schema: Mapping, observed: Mapping) -> dict:
    """Draft an overlay from a schema diff by shape-matching.

    ``schema``/``observed`` map key → shape (the inspector's view of the
    documented schema and the real checkpoint). Observed-only keys are
    matched to schema-only keys sharing the exact shape; a unique match
    becomes a ``rename`` entry, then rename pairs that differ only in a
    leading path segment are compressed into ``prefix`` rules. Ambiguous
    shapes land in ``_unresolved`` (ignored by :func:`apply_key_map`) for
    the human to finish. The draft is a starting point: check it with
    ``tools/inspect_checkpoint_torch.py --family <name>`` until the diff
    is empty.
    """
    missing = {k: tuple(v) for k, v in schema.items() if k not in observed}
    unexpected = {k: tuple(v) for k, v in observed.items()
                  if k not in schema}
    by_shape: dict = {}
    for k, s in missing.items():
        by_shape.setdefault(s, []).append(k)
    def _suffix_len(a: str, b: str) -> int:
        pa, pb = a.split("."), b.split(".")
        n = 0
        while n < min(len(pa), len(pb)) and pa[-1 - n] == pb[-1 - n]:
            n += 1
        return n

    renames, unresolved = {}, {}
    for k, s in sorted(unexpected.items()):
        cands = by_shape.get(s, [])
        if len(cands) == 1:
            renames[k] = cands[0]
        elif cands:
            # disambiguate same-shape candidates by longest common dotted
            # suffix (a prefix-style vendor rename leaves the whole module
            # path below the renamed prefix intact)
            scored = sorted(((_suffix_len(k, c), c) for c in cands),
                            reverse=True)
            if scored[0][0] > scored[1][0] and scored[0][0] > 0:
                renames[k] = scored[0][1]
            else:
                unresolved[k] = {"shape": list(s),
                                 "candidates": sorted(cands)[:8]}
        else:
            unresolved[k] = {"shape": list(s), "candidates": []}
    # consume each schema key at most once (a rename must be injective)
    used: dict = {}
    for k in list(renames):
        tgt = renames[k]
        if tgt in used:
            unresolved[k] = {"shape": list(unexpected[k]),
                             "candidates": [tgt],
                             "note": f"shape-collides with {used[tgt]!r}"}
            del renames[k]
        else:
            used[tgt] = k
    # compress into prefix rules: (src_prefix, dst_prefix) pairs that
    # explain >=2 renames with identical suffixes
    pair_count: dict = {}
    for src, dst in renames.items():
        sp, dp = src.split("."), dst.split(".")
        # longest common suffix
        n = 0
        while (n < min(len(sp), len(dp)) - 1
               and sp[-1 - n] == dp[-1 - n]):
            n += 1
        if n:
            pair = (".".join(sp[:-n]) + ".", ".".join(dp[:-n]) + ".")
            pair_count.setdefault(pair, []).append(src)
    prefixes = {}
    for (src_p, dst_p), keys in sorted(pair_count.items()):
        if len(keys) >= 2 and src_p != dst_p and src_p not in prefixes:
            prefixes[src_p] = dst_p
            for k in keys:
                del renames[k]
    # second pass: shape-ambiguous keys that a drafted prefix rule already
    # explains (towers share shapes; the rule learned from the unambiguous
    # keys disambiguates the rest)
    by_len = sorted(prefixes.items(), key=lambda kv: -len(kv[0]))
    for k in list(unresolved):
        nk = k
        for src_p, dst_p in by_len:
            if nk.startswith(src_p):
                nk = dst_p + nk[len(src_p):]
                break
        if nk in missing and nk not in used:
            used[nk] = k
            del unresolved[k]
    out: dict = {}
    if renames:
        out["rename"] = renames
    if prefixes:
        out["prefix"] = prefixes
    if unresolved:
        out["_unresolved"] = unresolved
    still_missing = sorted(set(missing) - set(used))
    if still_missing:
        out["_schema_keys_still_missing"] = still_missing
    return out
