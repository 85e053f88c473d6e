/* Host-side native kernels: LFSR PRBS generation.
 *
 * Counterpart of the reference's pythran-compiled LFSRs
 * (qampy/core/pythran_dsp.py:156-178). Bit generation is host work that
 * feeds the device pipeline; the Galois form is inherently bit-serial so a
 * small C kernel keeps multi-megabit pattern generation off the Python
 * interpreter. Loaded via ctypes (see qampy_tpu/prbs.py); a vectorised
 * numpy fallback exists for environments without a compiler.
 */
#include <stdint.h>
#include <stddef.h>

/* Fibonacci (external XOR) LFSR.
 * seed: initial register; taps: tap positions (1-based from MSB), ntaps of
 * them; nbits: register length; out: N output bits. */
void prbs_ext(uint64_t seed, const int32_t *taps, int32_t ntaps,
              int32_t nbits, uint8_t *out, int64_t N)
{
    uint64_t sr = seed;
    for (int64_t i = 0; i < N; i++) {
        uint64_t xor = 0;
        for (int32_t t = 0; t < ntaps; t++) {
            if (sr & (1ull << (nbits - taps[t])))
                xor ^= 1ull;
        }
        sr = (xor << (nbits - 1)) + (sr >> 1);
        out[i] = (uint8_t)xor;
    }
}

/* Galois (internal XOR) LFSR. */
void prbs_int(uint64_t seed, uint64_t mask, int32_t nbits,
              uint8_t *out, int64_t N)
{
    uint64_t state = seed;
    for (int64_t i = 0; i < N; i++) {
        state <<= 1;
        uint64_t xor = state >> nbits;
        if (xor)
            state ^= mask;
        out[i] = (uint8_t)xor;
    }
}
