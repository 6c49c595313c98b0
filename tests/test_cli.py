"""End-to-end CLI workflow tests (keygen -> encrypt -> gate/gate3/lut ->
decrypt -> noise) at the insecure-fast parameter sets, on CPU."""

import numpy as np
import pytest

from tfhe_jax.cli import main


def run(capsys, *argv):
    main(list(argv))
    return capsys.readouterr().out.strip()


@pytest.fixture(scope="module")
def keydir2(tmp_path_factory):
    d = tmp_path_factory.mktemp("keys2")
    main(["keygen", "--params", "test_insecure", "--out", str(d)])
    return d


@pytest.fixture(scope="module")
def keydir3(tmp_path_factory):
    d = tmp_path_factory.mktemp("keys3")
    main(["keygen", "--params", "test_insecure_3in", "--out", str(d)])
    return d


class TestCliGate:
    def test_nand_roundtrip(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "0101",
            "--out", f"{tmp_path}/a.npz")
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "0011",
            "--out", f"{tmp_path}/b.npz", "--seed", "2")
        run(capsys, "gate", "--server", f"{d}/server.npz", "--op", "nand",
            "--lhs", f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz",
            "--out", f"{tmp_path}/o.npz", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "1110"  # nand(0101, 0011)

    def test_not_needs_no_rhs(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "10",
            "--out", f"{tmp_path}/a.npz")
        run(capsys, "gate", "--server", f"{d}/server.npz", "--op", "not",
            "--lhs", f"{tmp_path}/a.npz", "--out", f"{tmp_path}/o.npz")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "01"

    def test_noise_report(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "11",
            "--out", f"{tmp_path}/a.npz")
        out = run(capsys, "noise", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/a.npz", "--expect", "11")
        assert "failures = 0/2" in out

    def test_mux(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        for name, bits in [("sel", "01"), ("a", "11"), ("b", "00")]:
            run(capsys, "encrypt", "--client", f"{d}/client.npz",
                "--bits", bits, "--out", f"{tmp_path}/{name}.npz")
        run(capsys, "gate", "--server", f"{d}/server.npz", "--op", "mux",
            "--sel", f"{tmp_path}/sel.npz", "--lhs", f"{tmp_path}/a.npz",
            "--rhs", f"{tmp_path}/b.npz", "--out", f"{tmp_path}/o.npz",
            "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "01"  # sel ? a : b


class TestCliGate3:
    def test_mux3(self, keydir3, tmp_path, capsys):
        d = str(keydir3)
        for name, bits in [("s", "01"), ("a", "11"), ("b", "00")]:
            run(capsys, "encrypt", "--client", f"{d}/client.npz",
                "--bits", bits, "--out", f"{tmp_path}/{name}.npz")
        run(capsys, "gate3", "--server", f"{d}/server.npz", "--op", "mux",
            "--in2", f"{tmp_path}/s.npz", "--in1", f"{tmp_path}/a.npz",
            "--in0", f"{tmp_path}/b.npz", "--out", f"{tmp_path}/o.npz",
            "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "01"

    def test_lut(self, keydir3, tmp_path, capsys):
        d = str(keydir3)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "0123",
            "--out", f"{tmp_path}/x.npz")
        # lut[i] = 3 - i over Z_8 inputs 0..3 (rest don't-care zeros)
        run(capsys, "lut", "--server", f"{d}/server.npz",
            "--in", f"{tmp_path}/x.npz", "--lut", "3,2,1,0,0,0,0,0",
            "--out", f"{tmp_path}/o.npz", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "3210"


class TestCliAdd:
    def test_add_roundtrip(self, keydir2, tmp_path, capsys):
        """4-bit encrypted add via the CLI: 0101 (5) + 0011 (3) = 1000 (8)."""
        d = str(keydir2)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "0101",
            "--out", f"{tmp_path}/a.npz")
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "0011",
            "--out", f"{tmp_path}/b.npz", "--seed", "2")
        run(capsys, "add", "--server", f"{d}/server.npz",
            "--lhs", f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz",
            "--out", f"{tmp_path}/s.npz", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/s.npz")
        assert out == "1000"

    def test_add_carry_out(self, keydir2, tmp_path, capsys):
        """--carry-out emits W+1 bits: 11 (3) + 11 (3) -> 110 (6)."""
        d = str(keydir2)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "11",
            "--out", f"{tmp_path}/a.npz")
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "11",
            "--out", f"{tmp_path}/b.npz", "--seed", "3")
        run(capsys, "add", "--server", f"{d}/server.npz",
            "--lhs", f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz",
            "--out", f"{tmp_path}/s.npz", "--carry-out", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/s.npz")
        assert out == "110"
