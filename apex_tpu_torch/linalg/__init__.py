"""Linear solvers of the port: the Schur complement of bundle adjustment
(implicit, by PCG, and explicit, a dense reduced camera matrix), the banded
block cyclic reduction and the banded QR sweep of pose graphs, the dense
Cholesky and QR solvers, the general-sparsity tier (independent-set block
elimination), and the matrix-free CG on the normal equations."""
