// K2: segmented scan.
//
// Replaces the JAX package's blocked associative scans, ops/scan.py:
// _blocked_scan (:28), seg_carry (:83), seg_min (:100), seg_max (:115) and
// cumsum (:130): an inclusive scan over run-start flags with add, min or max
// on u32 or i32 values, forward or reversed.
//
// Bound on the H100: bytes.  Per row it reads a 1-byte flag and a 4-byte
// value (or a 1-byte bool) and writes a 4-byte result, a handful of integer
// operations each.  The TPU's 512-lane blocked layout is not carried over:
// the engine (scan.cuh) is a single pass with decoupled look-back, so the
// inputs are read once and the result written once, in one launch after a
// memset of its status words, and a bool column is read as it is instead of
// through an int32 copy.
#include "scan.cuh"

namespace {

template <int OP>
int dispatch_signed(const uint8_t* flags, const void* vals, int val_bytes, uint32_t* out,
                    uint32_t* scratch, int64_t n, int is_signed, int reverse,
                    cudaStream_t stream) {
  if (is_signed)
    return dbt::seg_scan_launch<dbt::ValOp<OP, true>>(flags, vals, val_bytes, out, scratch, n,
                                                      reverse != 0, stream);
  return dbt::seg_scan_launch<dbt::ValOp<OP, false>>(flags, vals, val_bytes, out, scratch, n,
                                                     reverse != 0, stream);
}

}  // namespace

// op: 0 add, 1 min, 2 max.  flags may be null (plain scan).  val_bytes: 4
// for u32 values, 1 for bools.  tile_rows and scratch_words are the plan's
// (kernels/scan_plan.py); a plan that differs from the engine's is refused.
DBT_API int dbt_seg_scan(const void* flags, const void* vals, int val_bytes, void* out,
                         void* scratch, int64_t n, int op, int is_signed, int reverse,
                         int64_t tile_rows, int64_t scratch_words, void* stream) {
  if (tile_rows != dbt::SCAN_TILE || scratch_words != dbt::seg_scan_scratch_words(n))
    return (int)cudaErrorInvalidValue;
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case dbt::SCAN_ADD:
      return dispatch_signed<dbt::SCAN_ADD>(f, vals, val_bytes, o, s, n, is_signed, reverse, st);
    case dbt::SCAN_MIN:
      return dispatch_signed<dbt::SCAN_MIN>(f, vals, val_bytes, o, s, n, is_signed, reverse, st);
    case dbt::SCAN_MAX:
      return dispatch_signed<dbt::SCAN_MAX>(f, vals, val_bytes, o, s, n, is_signed, reverse, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

DBT_API const char* dbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
