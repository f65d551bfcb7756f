"""What a latest-wins KV store answers, worked out again from the ops.

The store's guarantees, as its configuration files state them: every
write (PUT) is acknowledged with the next logical seqno of the store,
counting from 0 in the order writes are applied; the writes of a batch
land first, in array order, and the batch's GETs then observe them; a GET
answers the seqno of the latest write to its key, or -1 when the key was
never written.

Keys are named by their index in the loaded population (the benchmark
makes every key from the population), so the store's state is one int64
array of latest seqnos.
"""

from __future__ import annotations

import numpy as np

PUT, GET = 0, 1


class LatestSeq:
    """The reference store: the latest seqno of every population key."""

    def __init__(self, n_keys: int):
        self.latest = np.full(n_keys, -1, np.int64)
        self.next_seq = 0

    def load(self, idx: np.ndarray) -> np.ndarray:
        """Write the keys ``idx`` in order; returns their seqnos."""
        return self._write(np.asarray(idx, np.int64))

    def _write(self, idx: np.ndarray) -> np.ndarray:
        seqs = np.arange(self.next_seq, self.next_seq + idx.shape[0],
                         dtype=np.int64)
        self.next_seq += idx.shape[0]
        # seqnos grow along the batch, so the latest write is the largest
        np.maximum.at(self.latest, idx, seqs)
        return seqs

    def batch(self, kinds: np.ndarray, idx: np.ndarray,
              reads_first: bool = False) -> np.ndarray:
        """The answers of one typed batch: a PUT's acknowledged seqno, a
        GET's seqno or -1.  ``reads_first`` breaks the guarantee that a
        batch's reads observe its writes (the control)."""
        out = np.empty(kinds.shape[0], np.int64)
        w = kinds == PUT
        g = kinds == GET
        if reads_first:
            out[g] = self.latest[idx[g]]
            out[w] = self._write(idx[w])
        else:
            out[w] = self._write(idx[w])
            out[g] = self.latest[idx[g]]
        return out


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Answers that differ (exact: seqnos are integers)."""
    got = np.asarray(got, np.int64)
    if got.shape != want.shape:
        return int(max(got.shape[0], want.shape[0]))
    return int(np.count_nonzero(got != want))


def latest_of_trace(ops: np.ndarray, key_idx: np.ndarray,
                    n_keys: int) -> np.ndarray:
    """The latest seqno of every key after a whole op stream whose writes
    are applied in stream order (the DES applies its windows in order and
    each window's writes in array order)."""
    ref = LatestSeq(n_keys)
    ref.load(key_idx[ops == PUT])
    return ref.latest
