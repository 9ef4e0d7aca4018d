#!/usr/bin/env bash
# A/B of the single-host stage walls of two checkouts on one card, in turns
# (old new new old old new, repeated): the flagship match_trie (1,048,576 segments x
# 25,000 barcodes) and extract_lr_bc (1,000,000 reads), each stage wall from
# SCTAG_STATS, outputs compared byte for byte. From the repository root:
#   git archive <commit> | tar -x -C baseline/parent
#   bash sctagger_tpu_torch/tools/ab_walls.sh baseline/parent . [ROUNDS [STAGES]]
# ROUNDS (default 1) repeats the six-run block; STAGES (default
# "match_trie extract_lr_bc") picks the stages. Walls go to stdout as
# "ARM <arm> <stage>=<s> ..."; the stats lines stay in build/ab/ and are
# copied to $AB_OUT when it is set.
set -e
ROOT=$PWD
OLD=$(cd "$1" && pwd); NEW=$(cd "$2" && pwd)
ROUNDS=${3:-1}; STAGES=${4:-match_trie extract_lr_bc}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for T in $NEW $OLD; do (cd $T && python -c "from sctagger_tpu_torch.ops import _build; _build.build(); _build.build_host()") ; done
D=$ROOT/build/ab; mkdir -p $D
python - <<PY
import sys, pathlib; sys.path[:0] = ["$ROOT", "$ROOT/tools"]
import bench, measure_reference
d = pathlib.Path("$D")
segs, bcs = bench.make_inputs(1_048_576, 25_000, seed=0)
(d / "sr.tsv").write_text("".join(f"{b}\t1\n" for b in bcs))
with open(d / "lr.tsv", "w") as f:
    f.writelines(f"r{i}\t0\t4\t{s}\n" for i, s in enumerate(segs))
if "extract_lr_bc" in "$STAGES":
    measure_reference.make_lr_fastq(d / "lr.fastq", 1_000_000, 2000, seed=42, err_rate=0.05)
PY
for round in $(seq $ROUNDS); do
for arm in old new new old old new; do
  if [ $arm = old ]; then T=$OLD; else T=$NEW; fi
  for stage in $STAGES; do
    if [ $stage = match_trie ]; then
      args="match_trie -lr $D/lr.tsv -sr $D/sr.tsv -mr 2 -o $D/out_$arm.tsv"
    else
      args="extract_lr_bc -r $D/lr.fastq -o $D/lr_$arm.tsv.gz"
    fi
    (cd $T && SCTAG_STATS=$D/st_$arm.jsonl python -m sctagger_tpu_torch $args > /dev/null 2>&1)
  done
  echo "ARM $arm $(tail -n $(echo $STAGES | wc -w) $D/st_$arm.jsonl | python -c 'import sys, json; print(" ".join(f"{json.loads(l)["stage"]}={json.loads(l)["wall_s"]}" for l in sys.stdin))')"
done
done
cmp $D/out_old.tsv $D/out_new.tsv && echo "match_trie outputs equal"
if [ -f $D/lr_new.tsv.gz ]; then
  cmp <(zcat $D/lr_old.tsv.gz) <(zcat $D/lr_new.tsv.gz) && echo "extract_lr_bc outputs equal"
fi
if [ -n "$AB_OUT" ]; then mkdir -p "$AB_OUT" && cp $D/st_*.jsonl "$AB_OUT"/; fi
