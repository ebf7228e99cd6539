"""``calibrate.py`` with the TF32 control in place of the bf16 one, for a
configuration whose entry builds it (``compute_dtype`` "tfloat32": the
float32 program with TF32 allowed in its embedding net's convolutions and
matmuls):

    python benchmark/calibrate_tf32.py --workload <cell> --seeds 1 2 3 ...

TF32 is the cheap way to make a float32 net of dense convolutions several
times faster, and it loses float32 accuracy: the cell's limits must hold
it out as they hold out the bf16 control, with the rest of the program in
float32.  Prints what ``calibrate.py``
prints, the control being the TF32 one.
"""

import calibrate
from entries.embed_cascade import TF32

if __name__ == "__main__":
    calibrate.CONTROL_DTYPE = TF32
    calibrate.main()
