#!/bin/bash
# Runs measuring scripts in this tree and in another checkout of the
# repository (the parent commit, say, unpacked with
# `git archive <commit> | tar -x -C build/parent`) on one GPU, in the order
# other, this, this, other, so that the two are compared within one machine.
# This tree's chip_smoke.py and the scripts named are copied into the other
# checkout first, so both are measured by the same code.
#
#   bash scripts/ab_kernels.sh OTHER_DIR OUT_DIR [COMMAND ...]
#
# Each COMMAND is one quoted command line run from a tree's root (default:
# the C6 and C7-C9 check scripts); the output of run n goes to
# OUT_DIR/<n>.<tree>.<k>.log, k the command's place in the list.
set -uo pipefail
here=$(cd "$(dirname "$0")/.." && pwd)
other=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
shift 2
commands=("$@")
if [ ${#commands[@]} -eq 0 ]; then
  commands=("python3 scripts/check_torch_scatter_rows.py"
            "python3 scripts/check_flash_attention.py")
fi
cp "$here/chip_smoke.py" "$other/"
mkdir -p "$other/scripts"
for c in "${commands[@]}"; do
  for word in $c; do
    case $word in
      scripts/*) cp "$here/$word" "$other/$word" ;;
    esac
  done
done
rc=0
n=0
for tree in other this this other; do
  n=$((n + 1))
  dir=$other
  [ "$tree" = this ] && dir=$here
  k=0
  for c in "${commands[@]}"; do
    k=$((k + 1))
    (cd "$dir" && eval "$c") > "$out/$n.$tree.$k.log" 2>&1
    e=$?
    [ $e -ne 0 ] && rc=1
    echo "run $n ($tree) command $k: exit $e -> $out/$n.$tree.$k.log"
  done
done
exit $rc
