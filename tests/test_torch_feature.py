"""The port's FM/FFM feature grammar (hivemall_tpu_torch/utils/feature.py
FMFeature) against the JAX package's (hivemall_tpu/utils/feature.py) on
the same tokens: ints, strings, 2- and 3-part tokens, and the error cases
(the same exception type and message)."""

import pytest

from hivemall_tpu.utils.feature import FMFeature as JFMFeature
from hivemall_tpu_torch.utils.feature import FMFeature as TFMFeature

TOKENS = ["3:17:1", "0:0:0.5", "63:1048575:1.0", "17:2.5", "age:31:1",
          "7:user_42:0.25", "site:ad:1", "-2:5:1", "4:-5:1", "x:-9:2",
          "1:99999999999:1", "  3 :  4 : 1 ", "f:i:1e-3", "12:34:-0"]


@pytest.mark.parametrize("tok", TOKENS)
@pytest.mark.parametrize("kw", [{}, {"num_features": 1 << 20,
                                     "num_fields": 64},
                                {"num_features": 97, "num_fields": 5}],
                         ids=["default", "2^20x64", "97x5"])
def test_fm_feature_parse_matches_jax(tok, kw):
    assert TFMFeature.parse(tok, **kw) == TFMFeature(
        **vars(JFMFeature.parse(tok, **kw)))


@pytest.mark.parametrize("tok", ["1:2:3:4", "5", "a:b:c", "1:2:x", "",
                                 "3::1", "4:-5:1"])
@pytest.mark.parametrize("as_int", [True, False])
def test_fm_feature_errors_match_jax(tok, as_int):
    try:
        want = JFMFeature.parse(tok, as_int=as_int)
    except Exception as e:  # the JAX package's refusal, mirrored below
        with pytest.raises(type(e)) as got:
            TFMFeature.parse(tok, as_int=as_int)
        assert str(got.value) == str(e)
    else:
        assert TFMFeature.parse(tok, as_int=as_int) == TFMFeature(
            **vars(want))
