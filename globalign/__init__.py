"""Drop-in compatibility package for ``globalign`` users.

``import globalign`` (or any of its submodules ``globalign.globaligner``,
``globalign.start``, ``globalign.conclude``) resolves to thin shims over the
device engine in :mod:`globalign_jax`, with the reference package's
module layout, function names, signatures, and nested-dict matrix formats
(reference: src/globalign/{globaligner,start,conclude}.py).  Scores and
costs are bit-identical to the reference; alignments are deterministic
where the reference tie-broke at random.

The reference's DP-internal API (``make_dp_array``,
``dp_array_forward``/``backward``, ``get_next_best_costs``, the four
``take_*`` move functions) is shimmed by list-of-lists adapters in
:mod:`globalign.dp_compat` — interpreted compatibility views over the
same semantics, NOT the device compute path.  ``cost_ranks_dispatcher`` is
deliberately absent: it exists only to drive the reference's random
tie-breaking, which this engine replaces with a deterministic order.
"""

from . import conclude, globaligner, start  # noqa: F401
from .globaligner import find_global_alignment  # noqa: F401
