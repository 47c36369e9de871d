"""The multi-device layer: row partitioners (:mod:`.partition`), the row mesh
and its ring transport (:mod:`.mesh`), and the row-sharded rings
(:mod:`.distributed`).  Counterpart of :mod:`sparse_matrix_mult_tpu.parallel`;
like it, not exported at the package's top level."""
