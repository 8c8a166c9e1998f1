"""Config parser tests: exact nbodyConfig.txt format compatibility
(/root/reference/include/nbodyConfig.h:22-227, /root/reference/nbodyConfig.txt).
"""

import pytest

from nbodyax.config import (ConfigError, SimConfig, apply_overrides,
                            parse_config_text)

# The shipped default scene, verbatim format (f-suffixed floats etc.)
DEFAULT_CONFIG = """\
particleCount=16384
totalIterations=2000
save_Image_Every_Xth_Iteration=10
timestep=0.2f
radiusGrowthRate=0.1f
minRandBodyMass=1e4f
maxRandBodyMass=1e17f
minRadius=50.f
maxRadius=200.f
imgWidth=1024
imgHeight=1024
fieldWidth=100000
fieldHeight=100000
imagePath=iter_img
"""


def test_parse_default_scene():
    cfg = parse_config_text(DEFAULT_CONFIG)
    assert cfg.particle_count == 16384
    assert cfg.total_iterations == 2000
    assert cfg.save_image_every == 10
    assert cfg.timestep == pytest.approx(0.2)
    assert cfg.growth_rate == pytest.approx(0.1)
    assert cfg.min_body_mass == pytest.approx(1e4)
    assert cfg.max_body_mass == pytest.approx(1e17)
    assert cfg.min_radius == 50.0 and cfg.max_radius == 200.0
    assert cfg.img_width == 1024 and cfg.img_height == 1024
    assert cfg.field_width == 100000 and cfg.field_height == 100000
    assert cfg.image_path == "iter_img"


def test_f_suffix_and_trailing_junk():
    # std::stof parses the longest valid prefix; trailing junk is ignored
    cfg = parse_config_text("timestep=0.5fxyz\nminRadius=1.25f\n")
    assert cfg.timestep == 0.5 and cfg.min_radius == 1.25


def test_stoi_prefix_semantics():
    # std::stoi("12abc") == 12
    cfg = parse_config_text("particleCount=12abc\n")
    assert cfg.particle_count == 12


def test_unknown_key_warn_ignored(capsys):
    cfg = parse_config_text("bogusKey=5\nparticleCount=7\n")
    assert cfg.particle_count == 7
    assert "Invalid variable: bogusKey" in capsys.readouterr().err


def test_removed_bh_pallas_key_warn_ignored(capsys):
    # bhPallas selected a near-field kernel that no longer exists; old
    # config files that still set it parse like any other unknown key
    cfg = parse_config_text("forceModel=bh\nbhPallas=on\nparticleCount=9\n")
    assert cfg.particle_count == 9 and cfg.force_model == "bh"
    assert not hasattr(cfg, "bh_pallas")
    assert "Invalid variable: bhPallas" in capsys.readouterr().err


def test_line_without_equals_ignored(capsys):
    cfg = parse_config_text("garbage line\nparticleCount=3\n")
    assert cfg.particle_count == 3
    assert "Invalid variable" in capsys.readouterr().err


def test_bad_value_raises():
    with pytest.raises(ConfigError):
        parse_config_text("particleCount=notanumber\n")
    with pytest.raises(ConfigError):
        parse_config_text("timestep=xx\n")


def test_extension_keys():
    cfg = parse_config_text(
        "softening=10.f\ncollisionMode=momentum\nintegrator=leapfrog\n"
        "backend=jnp\nshards=8\nseed=42\ncheckpointEvery=100\n")
    assert cfg.softening == 10.0
    assert cfg.collision_mode == "momentum"
    assert cfg.integrator == "leapfrog"
    assert cfg.backend == "jnp" and cfg.shards == 8 and cfg.seed == 42
    assert cfg.checkpoint_every == 100


def test_overrides():
    cfg = apply_overrides(SimConfig(), ["particleCount=99", "timestep=0.1f"])
    assert cfg.particle_count == 99 and cfg.timestep == pytest.approx(0.1)
    with pytest.raises(ConfigError):
        apply_overrides(SimConfig(), ["noSuchKey=1"])


def test_validation():
    with pytest.raises(ConfigError):
        parse_config_text("collisionMode=bogus\n")


def test_energy_every_requires_log_every_multiple():
    import pytest
    from nbodyax.config import ConfigError, SimConfig
    with pytest.raises(ConfigError, match="energyEvery"):
        SimConfig(energy_every=10, log_every=0).validate()
    with pytest.raises(ConfigError, match="energyEvery"):
        SimConfig(energy_every=10, log_every=7).validate()
    SimConfig(energy_every=10, log_every=5).validate()  # ok


def test_restitution_key_and_validation():
    cfg = apply_overrides(SimConfig(), ["collisionMode=elastic",
                                        "restitution=0.5f"])
    assert cfg.restitution == pytest.approx(0.5)
    cfg.validate()
    with pytest.raises(ConfigError, match="restitution"):
        apply_overrides(SimConfig(), ["restitution=1.5"]).validate()
    with pytest.raises(ConfigError, match="restitution"):
        apply_overrides(SimConfig(), ["restitution=-0.1"]).validate()
