"""Plain sequential tracebacks: the reference the device traceback scans
(ops/traceback_device.py) must match exactly."""
from typing import List, Tuple

import numpy as np

S_M, S_IX, S_IY = 0, 1, 2


def _rle(ops_rev: List[int]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for op in reversed(ops_rev):
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + 1)
        else:
            out.append((op, 1))
    return out


def nw_traceback(pointers: np.ndarray, lo: np.ndarray, b: int, m: int,
                 n: int, final_state: int) -> List[Tuple[int, int]]:
    """Affine-gap NW pointers (ptrM | ptrIx << 2 | ptrIy << 3) from (m, n)
    back to (0, 0); ops 0=M, 1=I (read), 2=D (ref)."""
    i, j, state = m, n, final_state
    ops_rev: List[int] = []
    while not (i == 0 and j == 0):
        p = int(pointers[i + j, i - int(lo[i + j]), b])
        if state == S_M and (i == 0 or j == 0):
            state = S_IX if i == 0 else S_IY
            continue
        if state == S_M:
            ops_rev.append(0)
            state = p & 0b11
            i, j = i - 1, j - 1
        elif state == S_IX:
            ops_rev.append(2)
            state = S_M if ((p >> 2) & 1) == 0 else S_IX
            j -= 1
        else:
            ops_rev.append(1)
            state = S_M if ((p >> 3) & 1) == 0 else S_IY
            i -= 1
        assert i >= 0 and j >= 0
    return _rle(ops_rev)


def mea_traceback(pointers: np.ndarray, lo: np.ndarray, b: int, m: int,
                  n: int) -> List[Tuple[int, int]]:
    """MEA pointers (0 = diag, 1 = left/D, else up/I) from (m, n)."""
    i, j = m, n
    ops_rev: List[int] = []
    while not (i == 0 and j == 0):
        if i == 0:
            ops_rev.append(2)
            j -= 1
            continue
        if j == 0:
            ops_rev.append(1)
            i -= 1
            continue
        p = int(pointers[i + j, i - int(lo[i + j]), b])
        if p == 0:
            ops_rev.append(0)
            i, j = i - 1, j - 1
        elif p == 1:
            ops_rev.append(2)
            j -= 1
        else:
            ops_rev.append(1)
            i -= 1
    return _rle(ops_rev)
