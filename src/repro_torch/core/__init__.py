"""Core mechanisms of the paper, ported: DGC accumulation (§5.1), ALDP
(§5.2), asynchronous mixing (Eq. 6), Alg. 2 detection, the moments
accountant and the data-level attacks."""
