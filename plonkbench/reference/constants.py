"""Field and curve constants for BLS12-381 and the embedded JubJub curve.

The reference (KogarashiNetwork/dusk-plonk `zkplonk`) builds on unmounted
sibling crates `bls-12-381` / `jub-jub`; the representation here is pinned by
the constants visible in the mounted crate:

* Fr is a 4x64-limb Montgomery field with R = 2^256: the hard-coded literal
  for -1 at reference `src/lib.rs:583-588` equals (r-1)*2^256 mod r.
* Permutation coset constants K1=7, K2=13, K3=17
  (reference `src/permutation.rs:28-30`).
"""

# ---------------------------------------------------------------------------
# BLS12-381 scalar field Fr (circuit field)
# ---------------------------------------------------------------------------
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FR_BITS = 255
FR_BYTES = 32
# multiplicative generator of Fr* (smallest: 7)
FR_GENERATOR = 7
# 2-adicity of r-1
FR_TWO_ADICITY = 32
# 2^32-th primitive root of unity: 7^((r-1)/2^32) mod r
FR_ROOT_OF_UNITY = 0x16A2A19EDFE81F20D09B681922C813B4B63683508C2280B93829971F439F0D2B
# Montgomery R for the device representation (16 x 16-bit limbs) and the
# reference's 4x64 representation: both use R = 2^256.
FR_MONT_R = (1 << 256) % R_MOD
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R_MOD
FR_MONT_INV_R = pow(FR_MONT_R, -1, R_MOD)

# ---------------------------------------------------------------------------
# BLS12-381 base field Fq
# ---------------------------------------------------------------------------
Q_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
FQ_BITS = 381
FQ_BYTES = 48
# Device representation: 24 x 16-bit limbs, R = 2^384.
FQ_MONT_R = (1 << 384) % Q_MOD
FQ_MONT_R2 = (FQ_MONT_R * FQ_MONT_R) % Q_MOD

# BLS parameter x (the curve is parameterised by x; x is negative).
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

# G1 generator (standard, from the IETF/zkcrypto spec)
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# G2 generator over Fq2 = Fq[u]/(u^2+1); coordinates (c0, c1)
G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# ---------------------------------------------------------------------------
# JubJub (twisted Edwards curve embedded over Fr): -x^2 + y^2 = 1 + d x^2 y^2
# ---------------------------------------------------------------------------
JUBJUB_A = R_MOD - 1  # a = -1
JUBJUB_D = (-10240 * pow(10241, -1, R_MOD)) % R_MOD

# Permutation argument coset multipliers (reference src/permutation.rs:28-30)
PERM_K1 = 7
PERM_K2 = 13
PERM_K3 = 17
