"""Path-list utilities mirroring the reference's bonsai helpers.

  * get_paths: read one path per line from a file
    (reference usage: src/distmain.cpp:113 `get_paths(paths_file)`).
  * Multi-file logical inputs: one "path" may be several space-separated
    files treated as one genome (`for_each_substr`, reference
    src/substrs.h:7-26, FNAME_SEP=' ' src/enums.h:4-8).
  * Size-descending sort for load balance (reference src/finalizers.cpp:6-28),
    disabled by --avoid-sorting.
"""
from __future__ import annotations

import os
from typing import List

FNAME_SEP = " "


def get_paths(list_path: str) -> List[str]:
    out = []
    with open(list_path) as fp:
        for line in fp:
            # strip surrounding whitespace, not just CRLF: a trailing
            # space survives into make_fname's first-space split and
            # collapses the cache basename to "" — every such line then
            # COLLIDES on one cache file (interior spaces stay: they are
            # the multi-file FNAME_SEP)
            line = line.strip()
            if line:
                out.append(line)
    return out


def split_subpaths(path: str) -> List[str]:
    """One logical input -> its component files (space-separated)."""
    parts = [p for p in path.split(FNAME_SEP) if p and not p.isspace()]
    return parts if parts else [path]


def path_size(path: str) -> int:
    """Total on-disk size of a (possibly multi-file) logical path."""
    total = 0
    for sub in split_subpaths(path):
        try:
            total += os.stat(sub).st_size
        except OSError:
            pass
    return total


def sort_paths_by_fsize(paths: List[str]) -> List[str]:
    """Descending file-size order.  The KEY truncates to uint32 exactly
    like the reference (its fsizes buffer is u32, finalizers.cpp:6-28),
    so >4 GiB genomes land where a reference run puts them — the sort
    order is an output surface (row/label order).  Ties break stably
    (the reference's std::sort leaves tie order unspecified)."""
    if len(paths) < 2:
        return paths
    return sorted(paths, key=lambda p: path_size(p) & 0xFFFFFFFF,
                  reverse=True)
