"""The reduced KKT system that K1 and K2 solve for one friction LCP.

A problem has nz variables (six per body), neq equality rows, k contacts,
each a normal row, fd friction rows and a cone row (nineq = k (2 + fd)).
Folding the friction pairs leaves m2 = neq + k + k fd / 2 rows of the
reduced system [A; G]_r Q^-1 [A; G]_r'. Q is the block-diagonal mass
matrix, so Q^-1 has 3 nonzeros in each of its rows.

- ``base``: [A; G]_r Q^-1 (2 m2 nz 3) and one triangle of its product with
  [A; G]_r' (m2 (m2 + 1) nz);
- ``lu_solve``: one LU of the m2 rows (2/3 m2^3) and one forward and
  backward substitution (2 m2^2).
"""


def m2(neq: int, k: int, fd: int) -> int:
    return neq + k + k * (fd // 2)


def base(nz: int, neq: int, k: int, fd: int) -> float:
    m = m2(neq, k, fd)
    return 2.0 * m * nz * 3 + m * (m + 1.0) * nz


def lu_solve(neq: int, k: int, fd: int) -> float:
    m = m2(neq, k, fd)
    return 2.0 * m**3 / 3.0 + 2.0 * m**2
