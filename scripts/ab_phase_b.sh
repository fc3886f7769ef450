#!/bin/bash
# chip_smoke.py's phase B (the 21 golden scenes rendered through
# Scene.render, then render_cuda timed with CUDA events) in two checkouts,
# a b b a, each in its own process, on one CUDA card. Prints each run's
# test13 ms/frame and the sum over the 21 scenes.
#   bash scripts/ab_phase_b.sh PARENT_DIR CHANGE_DIR
set -e
a=$(cd "$1" && pwd); b=$(cd "$2" && pwd)
for t in "$a" "$b" "$b" "$a"; do
  (cd "$t" && python3 -c "
import torch, chip_smoke as c
from quadray_tpu_torch.ops import _build
_build.load_libraries('whitted', 'conformance', 'cull')
torch.backends.cuda.matmul.allow_tf32 = False
scenes, _ = c.phase_b(torch.device('cuda', 0))
rows = c.phase_b_timing(scenes)
print('AB $t test13', rows['test13'][0],
      'sum21', sum(r[0] for r in rows.values()))
" 2>&1 | grep -E "^AB|Error")
done
