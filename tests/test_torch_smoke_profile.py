"""localai_tpu_torch.smoke_profile: the script runs under the sampler with
its own output and exit code, and each sample is charged to the phase the
main thread is in."""

import json
import subprocess
import sys
import textwrap

SCRIPT = textwrap.dedent("""
    import sys, time

    def busy(s):
        t = time.monotonic()
        while time.monotonic() - t < s:
            pass

    def phase_first():
        busy(0.4)

    def phase_second():
        busy(0.3)

    def main():
        phase_first()
        phase_second()
        print('{"ok": true}')
        sys.exit(3)

    if __name__ == "__main__":
        main()
""")


def test_samples_land_in_their_phases(tmp_path):
    script, out = tmp_path / "fake_smoke.py", tmp_path / "profile.json"
    script.write_text(SCRIPT)
    res = subprocess.run([sys.executable, "-m", "localai_tpu_torch.smoke_profile",
                          "--script", str(script), "--out", str(out), "--interval", "0.02"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 3, res.stderr
    assert res.stdout.strip().splitlines()[-1] == '{"ok": true}'
    report = json.loads(out.read_text())
    seconds = report["seconds"]
    first = sum(seconds["phase_first"]["main"].values())
    second = sum(seconds["phase_second"]["main"].values())
    # Each phase's samples cover its wall time, give or take a sample.
    assert 0.25 <= first <= 0.7 and 0.15 <= second <= 0.6, seconds
    assert first + second <= report["wall_s"]
    assert any(k.endswith(":busy") for k in report["leaves"]["main"]), report["leaves"]
