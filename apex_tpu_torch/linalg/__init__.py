"""Linear solvers of the port: the Schur complement of bundle adjustment
(implicit, by PCG, and explicit, a dense reduced camera matrix), the banded
block cyclic reduction and the banded QR sweep of pose graphs, the dense
Cholesky and QR solvers, and the matrix-free CG on the normal equations.
The general-sparsity tier is ROADMAP A.6."""
