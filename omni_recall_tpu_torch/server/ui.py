"""Thin built-in web UI.

Replaces the reference's Angular SPA (src/OmniRecall.App, 5 routed pages:
chat, documents, recall, eval, upload — app.routes.ts:8-15) with a single
static page served at ``/``, talking to the same REST API. Deliberately
dependency-free; the scriptable eval CLI (omni_recall_tpu/eval) is the
primary evaluation surface, this page is the interactive one.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Omni Recall TPU</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root { --fg:#1a1a1a; --muted:#667; --line:#d8dce3; --accent:#0b57d0; --bg:#f7f8fa; }
* { box-sizing: border-box; }
body { font: 15px/1.5 system-ui, sans-serif; color: var(--fg); background: var(--bg); margin: 0; }
header { background: #fff; border-bottom: 1px solid var(--line); padding: 10px 20px; display: flex; gap: 18px; align-items: baseline; }
header h1 { font-size: 17px; margin: 0 12px 0 0; }
nav a { color: var(--muted); text-decoration: none; cursor: pointer; }
nav a.active { color: var(--accent); font-weight: 600; }
main { max-width: 880px; margin: 24px auto; padding: 0 16px; }
section { display: none; } section.active { display: block; }
.card { background: #fff; border: 1px solid var(--line); border-radius: 8px; padding: 16px; margin-bottom: 14px; }
input[type=text], textarea { width: 100%; padding: 8px; border: 1px solid var(--line); border-radius: 6px; font: inherit; }
input[type=number] { width: 70px; padding: 8px; border: 1px solid var(--line); border-radius: 6px; }
button { background: var(--accent); color: #fff; border: 0; border-radius: 6px; padding: 8px 14px; font: inherit; cursor: pointer; }
button.ghost { background: #fff; color: var(--accent); border: 1px solid var(--line); }
.row { display: flex; gap: 10px; align-items: center; margin: 8px 0; }
.cite { border-left: 3px solid var(--accent); padding: 6px 10px; margin: 8px 0; background: var(--bg); border-radius: 4px; }
.cite .meta { color: var(--muted); font-size: 13px; }
.answer { white-space: pre-wrap; }
.ref { color: var(--accent); font-weight: 600; }
table { width: 100%; border-collapse: collapse; }
td, th { text-align: left; padding: 6px 8px; border-bottom: 1px solid var(--line); font-size: 14px; }
.muted { color: var(--muted); } .err { color: #b3261e; }
.pill { font-size: 12px; padding: 2px 8px; border-radius: 99px; background: var(--bg); border: 1px solid var(--line); }
.pass { color: #146c2e; } .fail { color: #b3261e; } .partial { color: #7a5c00; }
</style>
</head>
<body>
<header>
  <h1>Omni Recall <span class="muted">TPU</span></h1>
  <nav>
    <a data-page="chat" class="active">Chat</a>
    <a data-page="recall">Recall</a>
    <a data-page="documents">Documents</a>
    <a data-page="upload">Upload</a>
    <a data-page="eval">Eval</a>
  </nav>
</header>
<main>

<section id="page-chat" class="active">
  <div class="card">
    <div class="row"><input type="text" id="chat-prompt" placeholder="Ask about your documents...">
      <input type="number" id="chat-topk" value="5" min="1" max="10"><button onclick="runChat()">Send</button></div>
    <div id="chat-status" class="muted"></div>
  </div>
  <div id="chat-out"></div>
</section>

<section id="page-recall">
  <div class="card">
    <div class="row"><input type="text" id="recall-query" placeholder="Search your memory...">
      <input type="number" id="recall-topk" value="5" min="1" max="50"><button onclick="runRecall()">Search</button></div>
    <div id="recall-status" class="muted"></div>
  </div>
  <div id="recall-out"></div>
</section>

<section id="page-documents">
  <div class="card"><button class="ghost" onclick="loadDocs()">Refresh</button></div>
  <div class="card"><table id="doc-table"><thead><tr>
    <th>File</th><th>Chunks</th><th>Created</th><th></th></tr></thead><tbody></tbody></table></div>
  <div id="doc-detail"></div>
</section>

<section id="page-upload">
  <div class="card">
    <div class="row"><input type="file" id="up-file" accept=".txt,.md,.markdown,.pdf">
      <input type="text" id="up-source" placeholder="sourceType (default: file)" style="max-width:220px">
      <button onclick="runUpload()">Upload</button></div>
    <div id="up-status" class="muted"></div>
  </div>
</section>

<section id="page-eval">
  <div class="card">
    <div class="row"><button class="ghost" onclick="genCases()">Generate cases from documents</button>
      <button class="ghost" onclick="addCase()">Add case</button>
      <button onclick="runEval()">Run all</button><span id="eval-status" class="muted"></span></div>
    <div class="muted" style="font-size:13px">Cases persist in this browser (localStorage). Edit inline; chat runs once per expected-file group with all of the group's questions batched into one prompt.</div>
  </div>
  <div class="card"><table id="eval-table"><thead><tr>
    <th>Status</th><th>Question</th><th>Expected file</th><th>topK</th><th>Recall</th><th>Chat</th><th></th></tr></thead><tbody></tbody></table></div>
</section>

</main>
<script>
const $ = (s) => document.querySelector(s);
const api = {
  post: (p, body) => fetch(p, {method:'POST', headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)}).then(r => r.ok ? r.json() : r.json().then(e => Promise.reject(e))),
  get: (p) => fetch(p).then(r => r.ok ? r.json() : Promise.reject(r.status)),
  del: (p) => fetch(p, {method:'DELETE'}),
};
document.querySelectorAll('nav a').forEach(a => a.onclick = () => {
  document.querySelectorAll('nav a').forEach(x => x.classList.remove('active'));
  document.querySelectorAll('section').forEach(x => x.classList.remove('active'));
  a.classList.add('active');
  $('#page-' + a.dataset.page).classList.add('active');
  if (a.dataset.page === 'documents') loadDocs();
});
function esc(s) { const d = document.createElement('div'); d.textContent = s ?? ''; return d.innerHTML; }
function escA(s) { return esc(s).replace(/"/g, '&quot;'); }  // attribute-safe
function cites(list) {
  return (list || []).map((c, i) => `<div class="cite"><div class="meta">[${i+1}] ${esc(c.fileName)} · chunk ${c.chunkIndex} · score ${c.score.toFixed(4)}</div>${esc(c.snippet)}</div>`).join('');
}
function markers(text) { return esc(text).replace(/\\[(\\d+)\\]/g, '<span class="ref">[$1]</span>'); }

async function runChat() {
  $('#chat-status').textContent = 'thinking...';
  try {
    const r = await api.post('/api/chat', {prompt: $('#chat-prompt').value, topK: +$('#chat-topk').value});
    $('#chat-status').innerHTML = `<span class="pill">${esc(r.provider)} / ${esc(r.model)}</span>`;
    $('#chat-out').innerHTML = `<div class="card answer">${markers(r.answer)}</div>` + cites(r.citations);
  } catch (e) { $('#chat-status').innerHTML = `<span class="err">${esc(e.error || e.detail || 'error')}</span>`; }
}
async function runRecall() {
  $('#recall-status').textContent = 'searching...';
  try {
    const r = await api.post('/api/recall/search', {query: $('#recall-query').value, topK: +$('#recall-topk').value});
    $('#recall-status').textContent = `${r.citations.length} citations`;
    $('#recall-out').innerHTML = cites(r.citations);
  } catch (e) { $('#recall-status').innerHTML = `<span class="err">${esc(e.error || 'error')}</span>`; }
}
async function loadDocs() {
  const docs = await api.get('/api/documents');
  $('#doc-table tbody').innerHTML = docs.map(d =>
    `<tr><td>${esc(d.fileName)}</td><td>${d.chunkCount}</td><td class="muted">${esc(d.createdAtUtc)}</td>
     <td><button class="ghost" onclick="showChunks('${d.documentId}')">chunks</button>
         <button class="ghost" onclick="reindex('${d.documentId}')">reindex</button>
         <button class="ghost" onclick="delDoc('${d.documentId}')">delete</button></td></tr>`).join('');
}
async function showChunks(id) {
  const chunks = await api.get(`/api/documents/${id}/chunks`);
  $('#doc-detail').innerHTML = '<div class="card">' + chunks.map(c =>
    `<div class="cite"><div class="meta">chunk ${c.chunkIndex} · ${c.hasEmbedding ? 'embedded' : 'no embedding'}</div>${esc(c.snippet)}</div>`).join('') + '</div>';
}
async function reindex(id) {
  const r = await api.post(`/api/documents/${id}/reindex`, {});
  $('#doc-detail').innerHTML = `<div class="card">reindexed: ${r.embeddedCount} embedded, ${r.rateLimitedCount} rate-limited, ${r.emptyCount} empty, ${r.failedCount} failed</div>`;
}
async function delDoc(id) { await api.del(`/api/documents/${id}`); loadDocs(); }
async function runUpload() {
  const f = $('#up-file').files[0];
  if (!f) { $('#up-status').textContent = 'pick a file first'; return; }
  const fd = new FormData();
  fd.append('file', f);
  const st = $('#up-source').value.trim(); if (st) fd.append('sourceType', st);
  $('#up-status').textContent = 'uploading...';
  const r = await fetch('/api/documents/upload', {method: 'POST', body: fd});
  const body = await r.json().catch(() => ({}));
  $('#up-status').innerHTML = r.ok
    ? `ingested <b>${esc(body.fileName)}</b> — ${body.chunkCount} chunks`
    : `<span class="err">${esc(body.error || body.detail || ('HTTP ' + r.status))}</span>`;
}
// -- eval page: editable cases, localStorage persistence, grouped batch
//    chat — mirroring the reference eval page (eval.page.ts:56 storageKey,
//    :426-473 load/persist/parse, :231 group-by-expected-file,
//    :291-344 one batched chat per group with numbered questions) --
const EVAL_KEY = 'omni-recall-rag.eval-cases.v1';
let evalCases = [];
let evalResults = {};
function loadCases() {
  try {
    const parsed = JSON.parse(localStorage.getItem(EVAL_KEY) || '[]');
    if (!Array.isArray(parsed)) return [];
    return parsed.filter(c => c && typeof c === 'object').map((c, i) => ({
      id: typeof c.id === 'string' ? c.id : ('case-' + i + '-' + Date.now()),
      question: typeof c.question === 'string' ? c.question : '',
      expectedFile: typeof c.expectedFile === 'string' ? c.expectedFile : '',
      topK: Math.min(10, Math.max(1, Math.trunc(typeof c.topK === 'number' ? c.topK : 5))),
    }));
  } catch (e) { return []; }
}
function persistCases() {
  try { localStorage.setItem(EVAL_KEY, JSON.stringify(evalCases)); } catch (e) {}
}
function addCase() {
  evalCases.push({id: 'case-' + Date.now() + '-' + Math.random().toString(36).slice(2, 7),
                  question: '', expectedFile: '', topK: 5});
  persistCases(); renderEval();
}
function removeCase(id) {
  evalCases = evalCases.filter(c => c.id !== id);
  delete evalResults[id];
  persistCases(); renderEval();
}
function editCase(id, field, value) {
  const c = evalCases.find(x => x.id === id);
  if (!c) return;
  c[field] = field === 'topK' ? Math.min(10, Math.max(1, Math.trunc(+value || 5))) : value;
  persistCases();
}
async function genCases() {
  const docs = await api.get('/api/documents');
  evalCases = [];
  evalResults = {};
  for (const d of docs.slice(0, 10)) {
    const chunks = await api.get(`/api/documents/${d.documentId}/chunks`);
    const cands = chunks.filter(c => (c.snippet || '').trim().length > 20).slice(0, 4);
    const tmpl = [
      t => `Summarize the section about "${t}" in ${d.fileName}.`,
      t => `What concrete outcomes are described in the "${t}" section of ${d.fileName}?`,
      t => `Rewrite the "${t}" section from ${d.fileName} with stronger, specific wording.`,
    ];
    cands.forEach((c, i) => {
      const topic = c.snippet.split(/[.!?]/, 1)[0].trim().split(/\\s+/).slice(0, 8).join(' ');
      evalCases.push({id: 'case-' + d.documentId + '-' + i,
                      question: tmpl[i % 3](topic), expectedFile: d.fileName, topK: 5});
    });
  }
  persistCases(); renderEval();
  $('#eval-status').textContent = `${evalCases.length} cases`;
}
function renderEval() {
  // handlers bind by row index AFTER render — interpolating c.id into an
  // inline onclick would let a crafted id (localStorage is attacker-
  // editable; genCases derives ids from document ids) break out of the JS
  // string and execute script
  const tbody = $('#eval-table tbody');
  tbody.innerHTML = evalCases.map((c, i) => {
    const r = evalResults[c.id] || {};
    const status = r.status || 'pending';
    return `<tr data-i="${i}"><td class="${esc(status)}">${esc(status)}</td>
     <td><input type="text" data-f="question" value="${escA(c.question)}"></td>
     <td><input type="text" data-f="expectedFile" value="${escA(c.expectedFile)}" style="max-width:160px"></td>
     <td><input type="number" data-f="topK" value="${c.topK}" min="1" max="10"></td>
     <td>${r.recallHit === undefined ? '' : (r.recallHit ? 'hit' : 'miss')}</td>
     <td title="${escA(r.detail || '')}">${r.chatHit === undefined ? '' : (r.chatHit ? 'hit' : (r.guardBlocked ? 'guard' : 'miss'))}</td>
     <td><button class="ghost" data-rm>x</button></td></tr>`;
  }).join('');
  tbody.querySelectorAll('tr').forEach(tr => {
    const c = evalCases[+tr.dataset.i];
    if (!c) return;
    tr.querySelectorAll('input[data-f]').forEach(inp => {
      inp.onchange = () => editCase(c.id, inp.dataset.f, inp.value);
    });
    tr.querySelector('[data-rm]').onclick = () => removeCase(c.id);
  });
}
function groupByExpectedFile(cases) {
  const groups = new Map();
  for (const c of cases) {
    const key = (c.expectedFile || '').trim().toLowerCase();
    if (!groups.has(key)) groups.set(key, []);
    groups.get(key).push(c);
  }
  return [...groups.values()];
}
async function runEval() {
  const norm = (s) => (s || '').trim().toLowerCase();
  evalResults = {};
  for (const c of evalCases) evalResults[c.id] = {status: 'pending'};
  renderEval();
  for (const group of groupByExpectedFile(evalCases)) {
    // stage 1: a recall probe per case (eval.page.ts:286-301)
    for (const c of group) {
      evalResults[c.id] = {status: 'running'};
      renderEval();
      try {
        const r = await api.post('/api/recall/search', {query: c.question, topK: c.topK});
        evalResults[c.id] = {status: 'running',
          recallHit: r.citations.some(x => norm(x.fileName) === norm(c.expectedFile))};
      } catch (e) {
        evalResults[c.id] = {status: 'error', recallHit: false, detail: String(e && (e.error || e.detail) || e)};
      }
      renderEval();
    }
    // stage 2: ONE batched chat for the whole group — numbered questions
    // in a single prompt (eval.page.ts:291-344 buildBatchPrompt)
    const valid = group.filter(c => c.question.trim() && c.expectedFile.trim());
    let chat = {available: false, chatHit: false, guardBlocked: false, detail: 'No valid questions in this batch.'};
    if (valid.length) {
      const topK = valid.reduce((mx, c) => Math.max(mx, Math.min(10, Math.max(1, c.topK || 5))), 1);
      const prompt = 'Answer each of the following questions using the indexed documents:\\n'
        + valid.map((c, i) => `${i + 1}. ${c.question.trim()}`).join('\\n');
      try {
        const resp = await api.post('/api/chat', {prompt, topK});
        const guardBlocked = resp.provider === 'guard';
        chat = {available: true, guardBlocked,
                chatHit: !guardBlocked && resp.citations.some(x => norm(x.fileName) === norm(valid[0].expectedFile)),
                detail: guardBlocked ? 'Insufficient evidence guard.' : `${resp.provider} / ${resp.model}`};
      } catch (e) { chat = {available: false, chatHit: false, guardBlocked: false, detail: 'Chat failed: ' + String(e && (e.error || e.detail) || e)}; }
    }
    for (const c of group) {
      const r = evalResults[c.id] || {};
      if (r.status === 'error') continue;
      const status = r.recallHit && chat.chatHit ? 'pass' : (r.recallHit ? 'partial' : 'fail');
      evalResults[c.id] = {...r, status, chatHit: chat.available ? chat.chatHit : undefined,
                           guardBlocked: chat.guardBlocked, detail: chat.detail};
    }
    renderEval();
  }
  const rows = Object.values(evalResults);
  const passed = rows.filter(r => r.status === 'pass').length;
  const recalls = rows.filter(r => r.recallHit).length;
  $('#eval-status').textContent = `${passed}/${rows.length} pass · recall ${recalls}/${rows.length}`;
}
evalCases = loadCases();
renderEval();
</script>
</body>
</html>
"""

SWAGGER_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8"><title>Omni Recall TPU — API</title>
<style>
body { font: 15px/1.5 system-ui, sans-serif; max-width: 820px; margin: 30px auto; color: #1a1a1a; padding: 0 16px; }
h1 { font-size: 20px; } .path { font-family: ui-monospace, monospace; }
.op { border: 1px solid #d8dce3; border-radius: 8px; padding: 10px 14px; margin: 10px 0; }
.m { display: inline-block; min-width: 58px; font-weight: 700; }
.get { color: #146c2e; } .post { color: #0b57d0; } .delete { color: #b3261e; }
.codes { color: #667; font-size: 13px; }
</style>
</head>
<body>
<h1>Omni Recall TPU API</h1>
<p>Machine-readable spec: <a href="/swagger/v1/swagger.json">/swagger/v1/swagger.json</a></p>
<div id="ops"></div>
<script>
fetch('/swagger/v1/swagger.json').then(r => r.json()).then(spec => {
  const out = [];
  for (const [path, methods] of Object.entries(spec.paths)) {
    for (const [method, op] of Object.entries(methods)) {
      const codes = Object.entries(op.responses || {}).map(([c, r]) => `${c} ${r.description}`).join(' · ');
      out.push(`<div class="op"><span class="m ${method}">${method.toUpperCase()}</span>` +
               `<span class="path">${path}</span><div class="codes">${codes}</div></div>`);
    }
  }
  document.getElementById('ops').innerHTML = out.join('');
});
</script>
</body>
</html>
"""
