"""``.mat`` dataset loading (port of the loader of
``cbfssm_tpu/data/ds_manager.py``). Files store keys
``ds_u / ds_x / ds_y / title``; arrays are 2-D ``[ds_size, dim]``."""

from __future__ import annotations

import numpy as np
import scipy.io


class DSManager:
    @staticmethod
    def load_ds(filename):
        """(u, x, y) float64 arrays of one ``.mat`` file."""
        ds = scipy.io.loadmat(filename)
        print("Loaded Dataset " + "".join(ds["title"]))
        return tuple(ds[k].astype(np.float64) for k in ("ds_u", "ds_x", "ds_y"))
