"""Twins of ``tests/test_config_precedence.py`` for the port's daemon
config: defaults < TOML < .env < SERVER_* env < CLI flags.

Every case resolves the same files and environment through both packages
(``cpzk_tpu.server.__main__`` and ``cpzk_tpu_torch.server.__main__``) and
holds the port to the reference's values, with the port's one departure
from the defaults: ``[tpu] backend = "tpu"`` (the card).  ``[admission]
enabled`` defaults to true in both, and ``RetrySettings.build_policy``
builds the same retry policy in both.
"""

import dataclasses
import os

import pytest

from cpzk_tpu.server import __main__ as j_main
from cpzk_tpu.server.config import ServerConfig as JServerConfig
from cpzk_tpu_torch.server import __main__ as t_main
from cpzk_tpu_torch.server.config import ServerConfig

#: the port's defaults that differ from the reference's, by design
DEPARTURES = {("tpu", "backend"): ("cpu", "tpu")}


@pytest.fixture()
def clean_env(tmp_path, monkeypatch):
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)  # isolate .env discovery
    monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "server.toml"))
    return tmp_path


def resolve_both(argv=()):
    """(reference config, port config) from the same layers."""
    return (j_main.resolve_config(j_main.parse_args(list(argv))),
            t_main.resolve_config(t_main.parse_args(list(argv))))


def assert_same(ref, port, departures=DEPARTURES):
    """Every section and key equal, except the departures, where each
    side holds its own default (unless a layer set the key)."""
    r, p = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert r.keys() == p.keys()
    for section in r:
        if not isinstance(r[section], dict):
            assert r[section] == p[section], section
            continue
        assert r[section].keys() == p[section].keys(), section
        for key in r[section]:
            want = departures.get((section, key))
            if want is not None and (r[section][key], p[section][key]) == want:
                continue
            assert r[section][key] == p[section][key], f"{section}.{key}"


def test_defaults(clean_env):
    ref, cfg = resolve_both()
    assert (cfg.host, cfg.port) == ("127.0.0.1", 50051)
    assert cfg.rate_limit.requests_per_minute == 100
    assert cfg.metrics.enabled is False
    assert cfg.tpu.backend == "tpu"     # the port's departure: the card
    assert ref.tpu.backend == "cpu"
    assert cfg.admission.enabled is True and ref.admission.enabled is True
    assert_same(ref, cfg)
    assert set(dataclasses.asdict(cfg)) == set(dataclasses.asdict(JServerConfig()))


def test_toml_layer_survives_argparse(clean_env):
    (clean_env / "server.toml").write_text(
        'host = "0.0.0.0"\nport = 60000\n'
        "[rate_limit]\nrequests_per_minute = 500\n"
        "[metrics]\nenabled = true\n"
        '[tpu]\nbackend = "tpu"\nbatch_max = 128\n'
    )
    ref, cfg = resolve_both()
    assert (cfg.host, cfg.port) == ("0.0.0.0", 60000)
    assert cfg.rate_limit.requests_per_minute == 500
    assert cfg.metrics.enabled is True
    assert (cfg.tpu.backend, cfg.tpu.batch_max) == ("tpu", 128)
    assert_same(ref, cfg, departures={})


def test_env_overrides_toml(clean_env, monkeypatch):
    (clean_env / "server.toml").write_text('port = 60000\n')
    monkeypatch.setenv("SERVER_PORT", "61000")
    monkeypatch.setenv("SERVER_RATE_LIMIT_REQUESTS_PER_MINUTE", "42")
    monkeypatch.setenv("SERVER_TPU_BATCH_WINDOW_MS", "9.5")
    ref, cfg = resolve_both()
    assert cfg.port == 61000
    assert cfg.rate_limit.requests_per_minute == 42
    assert cfg.tpu.batch_window_ms == 9.5
    assert_same(ref, cfg)


def test_dotenv_under_env(clean_env, monkeypatch):
    (clean_env / ".env").write_text(
        "SERVER_PORT=59000\nSERVER_METRICS_ENABLED=true\n"
    )
    monkeypatch.setenv("SERVER_PORT", "58000")  # real env beats .env
    ref, cfg = resolve_both()
    assert cfg.port == 58000
    assert cfg.metrics.enabled is True
    assert_same(ref, cfg)


def test_cli_is_top_layer(clean_env, monkeypatch):
    (clean_env / "server.toml").write_text('port = 60000\nhost = "0.0.0.0"\n')
    monkeypatch.setenv("SERVER_PORT", "61000")
    argv = ["--port", "62000", "--rate-limit", "7", "--backend", "cpu"]
    ref, cfg = resolve_both(argv)
    assert cfg.port == 62000          # CLI beats env beats TOML
    assert cfg.host == "0.0.0.0"      # unset flags leave lower layers intact
    assert cfg.rate_limit.requests_per_minute == 7
    assert cfg.tpu.backend == "cpu"   # the caller asking for the host
    assert_same(ref, cfg)


def test_validation_still_runs(clean_env):
    with pytest.raises(ValueError) as ref_err:
        j_main.resolve_config(j_main.parse_args(["--rate-limit", "0"]))
    with pytest.raises(ValueError) as err:
        t_main.resolve_config(t_main.parse_args(["--rate-limit", "0"]))
    assert str(err.value) == str(ref_err.value)


def test_unknown_backend_rejected(clean_env):
    for cls in (JServerConfig, ServerConfig):
        cfg = cls()
        cfg.tpu.backend = "gpu"
        with pytest.raises(ValueError, match="Unknown verifier backend: gpu"):
            cfg.validate()


def test_empty_primary_env_beats_alias(clean_env, monkeypatch):
    """An explicitly-set empty primary name must not fall through to its
    short alias."""
    monkeypatch.setenv("SERVER_METRICS_ENABLED", "")
    monkeypatch.setenv("SERVER_METRICS", "true")
    cfg = ServerConfig.from_env()
    assert cfg.metrics.enabled is False
    assert JServerConfig.from_env().metrics.enabled is False

    monkeypatch.setenv("SERVER_RATE_LIMIT_BURST", "7")
    monkeypatch.setenv("SERVER_RATE_BURST", "99")
    assert ServerConfig.from_env().rate_limit.burst == 7
    assert JServerConfig.from_env().rate_limit.burst == 7


def test_resilience_knob_layering(clean_env, monkeypatch):
    """The resilience knobs resolve through the same precedence chain:
    TOML < env < CLI, and ``build_policy`` builds the reference's policy
    from them."""
    (clean_env / "server.toml").write_text(
        "[tpu]\nrecovery_after_s = 9.5\nprobe_batch_max = 16\n"
        "shed_expired = false\n"
        "[retry]\nmax_attempts = 7\nbudget = 2.5\n"
    )
    monkeypatch.setenv("SERVER_TPU_RECOVERY_AFTER_S", "4.0")
    monkeypatch.setenv("SERVER_TPU_SHED_EXPIRED", "true")
    monkeypatch.setenv("SERVER_RETRY_BUDGET", "3.5")
    monkeypatch.setenv("SERVER_RETRY_INITIAL_BACKOFF_MS", "25")
    ref, cfg = resolve_both()
    assert cfg.tpu.recovery_after_s == 4.0      # env beats TOML
    assert cfg.tpu.probe_batch_max == 16        # TOML beats default
    assert cfg.tpu.shed_expired is True         # env beats TOML
    assert cfg.retry.max_attempts == 7          # TOML beats default
    assert cfg.retry.budget == 3.5              # env beats TOML
    assert cfg.retry.initial_backoff_ms == 25.0
    assert_same(ref, cfg)

    mine, theirs = cfg.retry.build_policy(), ref.retry.build_policy()
    assert theirs.max_attempts == 7
    assert (mine.max_attempts, mine.initial_backoff_s, mine.max_backoff_s,
            mine.multiplier, mine.retryable_codes, mine.budget.tokens) == (
        theirs.max_attempts, theirs.initial_backoff_s, theirs.max_backoff_s,
        theirs.multiplier, theirs.retryable_codes, theirs.budget.tokens)
    assert type(mine).__module__ == "cpzk_tpu_torch.resilience.retry"
    cfg.retry.budget = ref.retry.budget = 0  # retries off: no policy
    assert cfg.retry.build_policy() is None and ref.retry.build_policy() is None


def test_resilience_knob_validation(clean_env):
    for cls in (JServerConfig, ServerConfig):
        cfg = cls()
        cfg.tpu.recovery_after_s = -2.0
        with pytest.raises(ValueError, match="recovery_after_s"):
            cfg.validate()
        cfg.tpu.recovery_after_s = -1.0  # sentinel: never self-heal
        cfg.validate()

        cfg = cls()
        cfg.tpu.probe_batch_max = 0
        with pytest.raises(ValueError, match="probe_batch_max"):
            cfg.validate()

        cfg = cls()
        cfg.retry.multiplier = 0.5
        with pytest.raises(ValueError, match="retry.multiplier"):
            cfg.validate()

        cfg = cls()
        cfg.retry.budget = 0.0
        cfg.validate()  # valid: retries disabled


def test_empty_int_env_keeps_default(clean_env, monkeypatch):
    """Deployment templates render optional vars as "": that must keep the
    default (and suppress the alias), not crash int("") at startup."""
    default_burst = ServerConfig.from_env().rate_limit.burst
    assert default_burst == JServerConfig.from_env().rate_limit.burst
    monkeypatch.setenv("SERVER_RATE_LIMIT_BURST", "")
    monkeypatch.setenv("SERVER_RATE_BURST", "99")
    assert ServerConfig.from_env().rate_limit.burst == default_burst
    assert JServerConfig.from_env().rate_limit.burst == default_burst
