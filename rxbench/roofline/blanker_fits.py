"""The blanker's sequential fits (``csrc/blanker_fits.cu``: a prep kernel
and the fits kernel a call): what one call must move and compute with m
fits run over r streams."""


def shape(geo, blk: int, streams: int) -> dict:
    """The call's sizes at a geometry and search block ``blk``: samples s
    and channels c a stream, the padded length and its blocks, the
    pulse's length (the blanker's refpulse bank, from the reference's
    tables)."""
    from rxbench.reference.ops.blanker import BlankerTables
    tables, _pw = BlankerTables.create(geo, "cpu")
    pul = int(tables.refbank.shape[-1])
    s = geo.samples_per_step
    total = max(-(-(s + 2 * pul) // blk) * blk, 2 * blk)
    return {"r": streams, "total": total, "c": geo.channels,
            "nblk": total // blk, "pul": pul, "s": s}


def bytes_ops(r: int, total: int, c: int, nblk: int, pul: int, s: int,
              m: int) -> tuple[int, int]:
    """Its inputs read once (the bank's rows those fits use), its outputs
    written once; per fit the two argmaxes, the window's arithmetic and
    the refresh of two blocks."""
    nbytes = r * (8 * total * c + 8 * total + 4 * nblk + 4 + 8 * s * c
                  + 4 * s + 4) + 8 * pul + 8 * pul * m
    ops = m * (nblk + 3 * (total // nblk) + 60 * pul * c)
    return nbytes, ops
