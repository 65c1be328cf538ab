"""Sketch-cache filename scheme (checkpoint/resume of the sketch phase).

Replicates make_fname (reference src/dashing.h:497-526) so cached sketches
are parameter-keyed:

    [prefix/]<base>.w.<k>.spacing<spacing>.[nt.|cyclic.][suf<suffix>.]<p><ext>

Quirk replicated on purpose: the reference writes ".w" and then evaluates
`ret + std::to_string(max(csz, wsz))` WITHOUT assigning it (dashing.h:510) —
the window size is never embedded, so the name always contains a bare ".w.".
We reproduce that so cache names line up with reference deployments.

<base> is the path with everything up to the first space dropped (multi-file
inputs) and, only when a prefix is given, directory components stripped.
"""
from __future__ import annotations

import os

from .paths import FNAME_SEP

ENCODING_INFIX = {"bonsai": "", "nthash": "nt.", "rk": "cyclic.",
                  "cyclic": "cyclic."}


def make_fname(path: str, sketch_p: int, wsz: int, k: int, csz: int,
               spacing: str = "", suffix: str = "", prefix: str = "",
               encoding: str = "bonsai", ext: str = ".hll") -> str:
    ret = ""
    if prefix:
        ret = prefix + "/"
    sep = path.find(FNAME_SEP)
    p = path[sep + 1:] if sep >= 0 else path
    if ret and "/" in p:
        ret += p.rsplit("/", 1)[1]
    else:
        ret += p
    ret += ".w"
    _ = str(max(csz, wsz))  # intentionally unused: reference quirk (see above)
    ret += "."
    ret += str(k)
    ret += ".spacing"
    ret += spacing
    ret += "."
    ret += ENCODING_INFIX[encoding]
    if suffix:
        ret += "suf" + suffix + "."
    ret += str(sketch_p)
    ret += ext
    return ret
