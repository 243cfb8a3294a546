// K2: segmented scan.
//
// Replaces the JAX package's blocked associative scans, ops/scan.py:
// _blocked_scan (:28), seg_carry (:83), seg_min (:100), seg_max (:115) and
// cumsum (:130): an inclusive scan over run-start flags with add, min or max
// on u32 or i32 values, forward or reversed.
//
// Bound on the H100: bytes.  Per row it reads a 1-byte flag and a 4-byte
// value and writes a 4-byte result, a handful of integer operations each.
// The TPU's 512-lane blocked layout is not carried over; the design is the
// three-phase block scan of scan.cuh (reduce, scan of tile carries,
// downsweep), so the input is read twice and the result written once, with
// coalesced loads and stores through shared memory.  The reversed form
// (stage A's any-S-after test) reads the arrays back to front instead of
// materializing flipped copies.
#include "scan.cuh"

namespace {

template <int OP>
int dispatch_signed(const uint8_t* flags, const uint32_t* vals, uint32_t* out,
                    uint32_t* scratch, int64_t n, int is_signed, int reverse,
                    cudaStream_t stream) {
  if (is_signed)
    return dbt::seg_scan_launch<dbt::ValOp<OP, true>>(flags, vals, out, scratch, n, reverse != 0, stream);
  return dbt::seg_scan_launch<dbt::ValOp<OP, false>>(flags, vals, out, scratch, n, reverse != 0, stream);
}

}  // namespace

DBT_API int64_t dbt_seg_scan_scratch_words(int64_t n) {
  return dbt::seg_scan_scratch_words(n);
}

// op: 0 add, 1 min, 2 max.  flags may be null (plain scan).
DBT_API int dbt_seg_scan(const void* flags, const void* vals, void* out, void* scratch,
                         int64_t n, int op, int is_signed, int reverse, void* stream) {
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case dbt::SCAN_ADD: return dispatch_signed<dbt::SCAN_ADD>(f, v, o, s, n, is_signed, reverse, st);
    case dbt::SCAN_MIN: return dispatch_signed<dbt::SCAN_MIN>(f, v, o, s, n, is_signed, reverse, st);
    case dbt::SCAN_MAX: return dispatch_signed<dbt::SCAN_MAX>(f, v, o, s, n, is_signed, reverse, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

DBT_API const char* dbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
