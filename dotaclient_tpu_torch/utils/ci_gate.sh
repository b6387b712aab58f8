#!/usr/bin/env bash
# One CI entrypoint for the port, the counterpart of the JAX package's
# scripts/ci_gate.sh: the port's tests, its strict lint, the telemetry
# schema contract (every learner --require-* tier against ONE smoke-run
# JSONL), the fused lane-sharding parity at world 2, and the serve fleet's
# router failover, with a greppable `CI_GATE <stage> PASS|FAIL` line per
# stage and a nonzero exit when any stage fails. Stages keep running after
# a failure so one invocation reports the full picture. (The reference's
# bench_gate stage waits for the port's benchmark: no stage is printed for
# it.)
#
# Every stage runs on the card; CI_GATE_DEVICE=cpu runs them on the CPU.
#
# Usage:
#   bash dotaclient_tpu_torch/utils/ci_gate.sh                        # all stages
#   CI_GATE_SKIP_TESTS=1 bash dotaclient_tpu_torch/utils/ci_gate.sh   # skip the pytest leg
#   CI_GATE_DEVICE=cpu bash dotaclient_tpu_torch/utils/ci_gate.sh     # on the CPU
set -u
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
cd "$REPO"

PY="${PYTHON:-python3}"
DEVICE_ARGS=()
if [ "${CI_GATE_DEVICE:-cuda}" = "cpu" ]; then
    DEVICE_ARGS=(--device cpu)
fi

FAILED=0
declare -a SUMMARY=()

report() {  # report <stage> <rc>
    local stage="$1" rc="$2"
    if [ "$rc" -eq 0 ]; then
        echo "CI_GATE ${stage} PASS"
        SUMMARY+=("${stage}: PASS")
    else
        echo "CI_GATE ${stage} FAIL (rc=${rc})"
        SUMMARY+=("${stage}: FAIL")
        FAILED=1
    fi
}

WORK="$(mktemp -d "${TMPDIR:-/tmp}/ci_gate_XXXXXX")"
trap 'rm -rf "$WORK"' EXIT

# -- stage 1: the port's tests -----------------------------------------------
if [ "${CI_GATE_SKIP_TESTS:-0}" = "1" ]; then
    echo "CI_GATE tests SKIP (CI_GATE_SKIP_TESTS=1)"
    SUMMARY+=("tests: SKIP")
else
    JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}" "$PY" -m pytest tests/test_torch_*.py -q -m 'not slow' \
        --continue-on-collection-errors -p no:cacheprovider
    report tests $?
fi

# -- stage 2: strict lint -------------------------------------------------------
"$PY" -m dotaclient_tpu_torch.lint --strict
report lint $?

# -- stage 3: telemetry schema (all learner tiers, one smoke JSONL) -----------
SMOKE_JSONL="$WORK/smoke.jsonl"
"$PY" -m dotaclient_tpu_torch.train.learner --smoke --steps 2 --metrics-jsonl "$SMOKE_JSONL" "${DEVICE_ARGS[@]}"
SMOKE_RC=$?
if [ "$SMOKE_RC" -ne 0 ]; then
    report schema_smoke "$SMOKE_RC"
else
    "$PY" -m dotaclient_tpu_torch.utils.check_telemetry_schema --path "$SMOKE_JSONL" \
        --require-snapshot --require-health --require-trace \
        --require-fleet --require-outcome --require-advantage \
        --require-multichip --require-utilization
    report schema $?
fi

# -- stage 4: fused lane-sharding parity -------------------------------------
# The fused iteration at world 1 and world 2 (gloo): per-dispatch losses and
# the float64 param L1 at reassociation tolerance, and the lane-sharding
# proof read off each rank's actor state. A SKIP (a broken environment,
# exit 0) checked nothing, so it fails the stage.
PARITY_OUT="$WORK/parity.out"
"$PY" -m dotaclient_tpu_torch.utils.run_multichip --fused-parity 2 --parity-steps 2 "${DEVICE_ARGS[@]}" \
    > "$PARITY_OUT"
PARITY_RC=$?
cat "$PARITY_OUT"
if [ "$PARITY_RC" -eq 0 ] && tail -n 1 "$PARITY_OUT" | grep -q '"skipped": true'; then
    echo "fused_parity: skipped, so nothing was checked"
    PARITY_RC=1
fi
report fused_parity "$PARITY_RC"

# -- stage 5: router failover ------------------------------------------------
# In-process serve-fleet failover: three backends, a session-affine router,
# a mid-game backend kill; the re-home must land bit-exact (exit 0 iff so)
# and the router's JSONL must carry its eagerly created router/* tier.
ROUTER_JSONL="$WORK/router.jsonl"
"$PY" -m dotaclient_tpu_torch.serve.loadgen --rehome-parity --metrics-jsonl "$ROUTER_JSONL" "${DEVICE_ARGS[@]}"
ROUTER_RC=$?
if [ "$ROUTER_RC" -ne 0 ]; then
    report router_failover "$ROUTER_RC"
else
    "$PY" -m dotaclient_tpu_torch.utils.check_telemetry_schema --path "$ROUTER_JSONL" --require-router
    report router_failover $?
fi

echo "== ci_gate summary =="
for line in "${SUMMARY[@]}"; do
    echo "  $line"
done
exit "$FAILED"
