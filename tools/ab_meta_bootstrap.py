#!/usr/bin/env python3
"""``chip_smoke.py``'s ``meta:bootstrap`` phase alone, twice, in one
checkout: the host seconds of the S/T/X learners' fit + ``ate_interval``
at the bootstrap cell (``paper_demo_data(100_000, 500)``, seed 123, B =
``META_BOOT_B`` in chunks of ``META_CHUNK``, "pallas"), with that
phase's own gates.

    for t in PARENT . . PARENT; do python3 tools/ab_meta_bootstrap.py $t; done

TREE is the root of a checkout (``git archive`` of a commit unpacked
into a directory ``.gitignore`` lists); the script imports that tree's
``chip_smoke`` and ``repro_torch``, so parent, change, change, parent in
one call compare two commits on one card.  It prints one line,
``AB {"tree": ..., "card": ..., "secs": {pass: {learner: s}}}``.
"""
import json
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.data.causal_dgp import paper_demo_data  # noqa: E402
from repro_torch.kernels.seg_gram import kernel as kern  # noqa: E402

kern.library()
base = CausalConfig(n_folds=5, nuisance_y="ridge", nuisance_t="logistic",
                    cate_features=2, engine="parallel", inference="bootstrap",
                    row_block=cs.META_RB, row_block_strategy="pallas",
                    n_bootstrap=cs.META_BOOT_B, runtime_chunk=cs.META_CHUNK)
bdata = paper_demo_data(n=cs.BOOT_N, p=500, seed=123)
out = {}
for rep in range(2):
    secs, _ = cs.phase_meta_bootstrap(bdata, base)
    out[rep] = secs
print("AB", json.dumps({"tree": root.name, "card": cs.card_line(),
                        "secs": out}))
