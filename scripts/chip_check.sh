#!/usr/bin/env bash
# Proves on a card that a tree's committed files are enough, as a harness
# checks it: runs chip_smoke.py from an unpacked archive of the tree, then
# alone in a directory that holds nothing else of the repository (where it
# must fail and print no result), then each further command from the tree.
# Every command is recorded with its exit code and seconds as one JSON line
# in OUT/commands.jsonl; each one's output goes to OUT/<k>.txt and OUT/<k>.err.
# Exits with chip_smoke.py's own code, else 1 when the lone copy did not
# fail, else the first nonzero code of the further commands.
#
#   mkdir -p archive_check/tree && git add -A && git archive $(git write-tree) | tar -x -C archive_check/tree
#   bash scripts/chip_check.sh archive_check/tree OUT "python3 -m pytest tests/test_torch_chol.py -m gpu -q"
#
# on the machine with the card (OUT any directory; archive_check/ is git-ignored).
set -u
tree=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
shift 2
log="$out/commands.jsonl"
: > "$log"

k=0
run() {  # dir, label, command: runs it, records its code, sets rc
    local t0=$SECONDS
    (cd "$1" && bash -c "$3") > "$out/$k.txt" 2> "$out/$k.err"
    rc=$?
    python3 -c 'import json, sys; print(json.dumps({"step": int(sys.argv[1]), "command": sys.argv[2], "where": sys.argv[3], "rc": int(sys.argv[4]), "seconds": int(sys.argv[5])}))' \
        "$k" "$3" "$2" "$rc" "$((SECONDS - t0))" >> "$log"
    k=$((k + 1))
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$tree" "the archive" "python3 chip_smoke.py"
smoke_rc=$rc
alone="$out/alone"
rm -rf "$alone"
mkdir -p "$alone"
cp "$tree/chip_smoke.py" "$alone/"
run "$alone" "alone in an empty directory" "python3 chip_smoke.py"
alone_rc=$rc
rm -rf "$alone"
extra_rc=0
for cmd in "$@"; do
    run "$tree" "the archive" "$cmd"
    if [ "$extra_rc" -eq 0 ]; then extra_rc=$rc; fi
done

cat "$log"
tail -n 1 "$out/0.txt"
if [ "$smoke_rc" -ne 0 ]; then exit "$smoke_rc"; fi
if [ "$alone_rc" -eq 0 ]; then exit 1; fi
exit "$extra_rc"
