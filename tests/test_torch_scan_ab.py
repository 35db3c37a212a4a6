"""scan_ab.py's reading of the coarse-scan kernel's mangled names.

``--sass`` files each coarse_scan_kernel<Shape, T, kScaled> instance of
the cubin under '<body> <form>'; the body is read from the name's own
length prefix, so a body struct added to csrc/coarse_scan.cu is filed
without a list to keep, and an instance that does not parse raises.
"""

import pytest

import scan_ab

#: nvcc's names: the kernel in the file's own anonymous namespace, its
#: template arguments through the substitution NS_
NV = ("_ZN47_GLOBAL__N__2646d9f1_14_coarse_scan_cu_8625029718"
      "coarse_scan_kernelINS_")
NV_BF2 = "NS_3Bf2E"
NV_TAIL = ("EEEvPKfS3_S3_S3_S3_PfPxS4_S4_iiiNS_9XYStridesENS_12PreTransformE"
           "ffS3_i")
#: g++'s names for the same template
NS = "_Z18coarse_scan_kernelIN12_GLOBAL__N_1"
BF2 = "NS0_3Bf2E"
TAIL = "EEvPKfS2_S2_S2_S2_iiiPfPlS3_S3_"


@pytest.mark.parametrize("mangled, want", [
    (NV + "3PieEf" + "Lb0" + NV_TAIL, "Pie float32"),
    (NV + "5HeartE" + NV_BF2 + "Lb0" + NV_TAIL, "Heart bfloat16"),
    (NV + "7RhombusE" + NV_BF2 + "Lb1" + NV_TAIL, "Rhombus scaled_bfloat16"),
    (NV + "13UnevenCapsuleEf" + "Lb1" + NV_TAIL,
     "UnevenCapsule scaled_float32"),
    (NV + "8GridBodyEf" + "Lb0" + NV_TAIL, "GridBody float32"),
    (NS + "5HeartEf" + "Lb0" + TAIL, "Heart float32"),
    (NS + "5HeartE" + BF2 + "Lb0" + TAIL, "Heart bfloat16"),
    (NS + "5HeartEf" + "Lb1" + TAIL, "Heart scaled_float32"),
    (NS + "7RhombusE" + BF2 + "Lb1" + TAIL, "Rhombus scaled_bfloat16"),
    (NS + "13UnevenCapsuleE" + BF2 + "Lb0" + TAIL,
     "UnevenCapsule bfloat16"),
    (NS + "14OrientedVesicaEf" + "Lb1" + TAIL,
     "OrientedVesica scaled_float32"),
    (NS + "8GridBodyEf" + "Lb0" + TAIL, "GridBody float32"),
    ("_Z18coarse_scan_kernelI5Heartf" + "Lb0" + TAIL, "Heart float32"),
    ("_Z12other_kernelPf", "_Z12other_kernelPf"),
])
def test_kernel_form_reads_any_body(mangled, want):
    assert scan_ab.kernel_form(mangled) == want


@pytest.mark.parametrize("mangled", [
    NS + "5HeartEd" + "Lb0" + TAIL,          # T is neither float nor Bf2
    NV + "3PieEd" + "Lb0" + NV_TAIL,
    NS + "5HeartEf" + TAIL,                  # no kScaled
    "_Z18coarse_scan_kernelIfLb0" + TAIL,     # no body
])
def test_kernel_form_raises_on_an_unparsed_instance(mangled):
    with pytest.raises(ValueError):
        scan_ab.kernel_form(mangled)
