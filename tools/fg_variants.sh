#!/usr/bin/env bash
# Time alternatives of kernel G's design (csrc/fine_interp.cu) on one card.
#
#   bash tools/fg_variants.sh NAME SOURCE SED [NAME SOURCE SED ...]
#
# For each NAME it copies the tree's jello_tpu_torch/ and tools/ into
# _archive/variant_NAME (git-ignored), applies the sed expression SED to
# the copy's jello_tpu_torch/csrc/SOURCE (image_tap.cu or
# fine_interp.cu), and runs
# `tools/torch_frame_times.py --kernels-fg --configs ""` there, so that
# each variant builds its own kernels and prints F's, G's and H's times
# and output digests (the log goes to $LOG_DIR/variant_NAME.log, LOG_DIR
# defaulting to _archive/), then ptxas's registers and spills for kernels
# F and G. An
# empty SED times the tree itself. Run it from the root of a checkout on
# a machine with the card.
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
logs=${LOG_DIR:-$root/_archive}
mkdir -p "$logs"
while [ $# -ge 3 ]; do
  name=$1 src=$2 expr=$3
  shift 3
  dir=$root/_archive/variant_$name
  rm -rf "$dir" && mkdir -p "$dir"
  cp -r "$root/jello_tpu_torch" "$root/tools" "$dir/"
  rm -rf "$dir/jello_tpu_torch/_build"
  if [ -n "$expr" ]; then sed -i "$expr" "$dir/jello_tpu_torch/csrc/$src"; fi
  (cd "$dir" && timeout 600 python3 tools/torch_frame_times.py --kernels-fg --configs "" \
    --tag "$name") > "$logs/variant_$name.log" 2>&1
  echo "variant $name: rc $?"
  (cd "$dir" && python3 -c 'from jello_tpu_torch.cuda import build; build.build(verbose=True, force=True)' \
    2>&1 | grep -E "Compiling entry|Used [0-9]+ registers" | grep -A1 -E "tile_kernel|image_tap_kernel" \
    | grep -o "Used [0-9]* registers.*")
  grep -h "sha256" "$logs/variant_$name.log" | cut -c1-330
done
