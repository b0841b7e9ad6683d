# The measurements that set a cell's bounds, on the card: a build run,
# two sets of six runs with the same six seeds, three traced runs, and,
# given calibrate's arguments, the check's readings.
#   bash benchmark/sets.sh <workload> <out-dir> [benchmark.calibrate arguments]
# Each run's output goes to <out-dir>, a summary line a run to stdout.
set -u
W=$1; D=$2; shift 2
SECONDS_RUN=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
mkdir -p $D
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() { # seed seconds trace tag
  python3 -m benchmark.run --workload $W --seed $1 --seconds $2 --trace $3 > $D/$4.out 2> $D/$4.err
  echo "== $4 seed=$1 s=$2 trace=$3 rc=$? $(tail -n 1 $D/$4.out | python3 -c 'import sys,json; d=json.loads(sys.stdin.read()); print(d["correct"], json.dumps({k: v["value"] for k, v in d["metrics"].items()}), json.dumps(d["device"]))')"
  grep "notes\|least" $D/$4.err | cut -c1-400
}
one 2147483790 2 0 build
for set in A B; do
  for s in 2147483801 2147483802 2147483803 2147483804 2147483805 2147483806; do one $s $SECONDS_RUN 0 $set.$s; done
done
for s in 2147483811 2147483812 2147483813; do one $s $SECONDS_RUN 1 T.$s; done
if [ $# -gt 0 ]; then
  python3 -m benchmark.calibrate --workload $W "$@" > $D/cal.jsonl 2> $D/cal.err
  echo "cal rc=$?"; cut -c1-330 $D/cal.jsonl; grep -v "^check" $D/cal.err | tail -3 | cut -c1-300
fi
