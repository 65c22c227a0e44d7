// config editor module: load the ON-DISK config, validate server-side,
// deploy through the same snapshot path as PUT /config/router, list
// versions, roll back. Uses app.js's $/esc/api helpers.
(() => {
  const out = msg => { $("cfg-out").textContent = msg; };

  function renderValidation(v) {
    const lines = [];
    lines.push(v.ok ? "VALID" : "INVALID");
    (v.errors || []).forEach(e => lines.push("error: " + e));
    (v.warnings || []).forEach(w => lines.push("warning: " + w));
    if (v.ok) {
      lines.push("decisions: " + (v.decisions || []).join(", "));
      lines.push("models: " + (v.models || []).join(", "));
      lines.push("hash: " + (v.hash || ""));
    }
    out(lines.join("\n"));
    $("cfg-status").textContent = v.ok ? "valid" : "invalid";
    $("cfg-status").className = v.ok ? "good-note" : "err";
  }

  function renderVersions(versions) {
    $("cfg-versions").innerHTML = (versions || []).slice(0, 8).map(v =>
      `<tr><td>${esc(v.id)}</td>` +
      `<td>${new Date(v.created * 1000).toLocaleTimeString()}</td>` +
      `<td>${esc((v.hash || "").slice(0, 12))}</td>` +
      `<td><button class="btn cfg-rb" data-v="${esc(v.id)}">` +
      `roll back</button></td></tr>`).join("");
    document.querySelectorAll(".cfg-rb").forEach(btn => {
      btn.onclick = async () => {
        try {
          await api("/config/router/rollback",
                    { version: btn.dataset.v });
          out("rolled back to " + btn.dataset.v +
              " (hot-reload applies it within the poll interval)");
          load();
        } catch (e) { out("rollback failed: " + e.message); }
      };
    });
  }

  async function load() {
    try {
      const raw = await api("/dashboard/api/config/raw");
      $("cfg-yaml").value = raw.yaml;
      renderVersions(raw.versions);
      out("loaded " + raw.path);
      $("cfg-status").textContent = "";
    } catch (e) { out("load failed: " + e.message); }
  }

  $("cfg-load").onclick = load;
  $("cfg-validate").onclick = async () => {
    try {
      renderValidation(await api("/dashboard/api/config/validate",
                                 { yaml: $("cfg-yaml").value }));
    } catch (e) { out("validate failed: " + e.message); }
  };
  $("cfg-deploy").onclick = async () => {
    try {
      // validate first: deploy is refused server-side on fatals anyway,
      // but the editor should never even attempt a known-bad write
      const v = await api("/dashboard/api/config/validate",
                          { yaml: $("cfg-yaml").value });
      renderValidation(v);
      if (!v.ok) return;
      const res = await api("/dashboard/api/config/deploy",
                            { yaml: $("cfg-yaml").value });
      out("deployed (backup " + res.backup_version + ", hash " +
          (res.hash || "").slice(0, 12) + ") — " + res.note);
      load();
    } catch (e) { out("deploy failed: " + e.message); }
  };
})();
